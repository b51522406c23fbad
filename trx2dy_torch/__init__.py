"""PyTorch/CUDA port of trx2dy (see README: "PyTorch/CUDA port")."""
