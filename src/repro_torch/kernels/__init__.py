"""Hand-written Hopper kernels, their plain versions (``ref``) and the
model-layout entry points (``ops``). Kernels build at first use."""
