"""The plain reference the benchmark judges the port's outputs by: plain
PyTorch, importing nothing of the port."""
