"""Level operations: plain PyTorch (`padded`) and the hand-written CUDA
kernels with their plain versions (`cuda`)."""
