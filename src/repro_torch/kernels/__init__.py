"""Hand-written Hopper kernels, their plain versions, and the ops that
pick between them by device."""
