"""The epoch loop (main.py:214-235): counterpart of ``vangan_tpu.training.loop``."""

from __future__ import annotations

import time

from vangan_torch.vangan import VanGan, train


def fit(
    cfg,
    gan: VanGan,
    dataset,
    summary,
    monitor=None,
    start_epoch: int = 0,
) -> None:
    """Epochs ``start_epoch`` .. ``EPOCHS - 1``: σ(epoch), a train epoch, a
    validation epoch, then panels and a checkpoint when ``epoch %
    PERIOD_2D_CALLBACK == 1`` or on the last epoch (main.py:230-232), and the
    epoch's wall time as the ``elapse`` scalar. The last checkpoint write
    is waited for, also when the loop raises."""
    cfg.require_one_device()
    train_iter = dataset.train_batches()
    val_iter = dataset.val_batches()

    try:
        for epoch in range(start_epoch, cfg.EPOCHS):
            print(f"\nEpoch {epoch + 1:03d}/{cfg.EPOCHS:03d}")
            start = time.time()
            gan.current_epoch = epoch

            if monitor is not None:
                noise_std = monitor.on_epoch_start(gan, epoch, dataset.train_steps)
            else:
                noise_std = cfg.noise_std_at_epoch(epoch)

            results = train(train_iter, gan, summary, epoch, dataset.train_steps,
                            "Train", training=True, noise_std=noise_std)
            summary.losses(results)

            results = train(val_iter, gan, summary, epoch, dataset.val_steps,
                            "Validate", training=False)
            summary.losses(results)

            if epoch % cfg.PERIOD_2D_CALLBACK == 1 or epoch == cfg.EPOCHS - 1:
                if monitor is not None:
                    monitor.on_epoch_end(gan, epoch)
                gan.save_checkpoint(epoch=epoch)

            summary.scalar("elapse", time.time() - start, epoch=epoch, training=True)
    finally:
        gan.checkpointer.wait_until_finished()
