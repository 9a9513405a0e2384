"""The port's MNIST example: `make_data.py` and the LeNet prototxts."""
