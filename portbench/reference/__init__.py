"""Plain PyTorch references of the benchmark's configurations.  They import
nothing of the program: every input is made again from the seed by
:mod:`portbench.generate`, and the program's outputs are only judged."""
