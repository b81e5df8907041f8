from vangan_torch.cli import main

main()
