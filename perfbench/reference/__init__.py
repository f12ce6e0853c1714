"""Plain references: numpy and PyTorch, importing nothing of the program."""
