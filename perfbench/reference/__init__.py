"""Plain references of the benchmark's configurations.  They import numpy
and torch only: nothing of the program, nothing of JAX."""
