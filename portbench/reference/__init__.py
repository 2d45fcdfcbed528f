"""The plain reference: numpy, independent of the program."""
