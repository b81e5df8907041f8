"""The plain reference of the benchmark: networks, losses, the train step with
its clipped Adam, and the stitcher, in ordinary PyTorch and NumPy. It imports
nothing of the measured program, and is run only after a run's timed window
has closed."""
