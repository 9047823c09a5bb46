"""The kernels: CUDA C++ for Hopper (``csrc/``), their wrappers,
their plain PyTorch versions (``ref``) and the dispatch between them
(``ops``). Importing this package builds nothing; the kernels compile at
first launch."""
