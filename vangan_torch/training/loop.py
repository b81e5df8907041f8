"""The epoch loop (main.py:214-235): counterpart of ``vangan_tpu.training.loop``."""

from __future__ import annotations

import time

from vangan_torch.parallel import is_main
from vangan_torch.vangan import VanGan, train


class NullSummary:
    """The summary of a rank that logs nothing (data parallelism: rank 0 logs)."""

    def scalar(self, name, value, epoch, training=True) -> None:
        pass

    def losses(self, results) -> None:
        pass


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
    is waited for, also when the loop raises. Under data parallelism
    (``gan.group``) every rank steps on its shards of the train and
    validation batches; rank 0 alone prints, logs to ``summary``, runs the
    ``monitor`` and saves (the others' ``summary`` and ``monitor`` are not
    read), and the ranks meet once the last write is on disk."""
    group = getattr(gan, "group", None)
    main = is_main(group)
    if not main:
        summary, monitor = NullSummary(), None
    train_iter = dataset.train_batches()
    val_iter = dataset.val_batches()

    try:
        for epoch in range(start_epoch, cfg.EPOCHS):
            if main:
                print(f"\nEpoch {epoch + 1:03d}/{cfg.EPOCHS:03d}")
            start = time.time()
            gan.current_epoch = epoch

            if monitor is not None:
                noise_std = monitor.on_epoch_start(gan, epoch, dataset.train_steps)
            else:
                noise_std = cfg.noise_std_at_epoch(epoch)

            results = train(train_iter, gan, summary, epoch, dataset.train_steps,
                            "Train" if main else None, training=True, noise_std=noise_std)
            summary.losses(results)

            results = train(val_iter, gan, summary, epoch, dataset.val_steps,
                            "Validate" if main else None, training=False)
            summary.losses(results)

            if epoch % cfg.PERIOD_2D_CALLBACK == 1 or epoch == cfg.EPOCHS - 1:
                if monitor is not None:
                    monitor.on_epoch_end(gan, epoch)
                gan.save_checkpoint(epoch=epoch)

            summary.scalar("elapse", time.time() - start, epoch=epoch, training=True)
    finally:
        gan.checkpointer.wait_until_finished()
    if group is not None:
        group.barrier()
