"""Plain PyTorch and NumPy references of what the program computes, written
from the equations.  Nothing here imports the program."""
