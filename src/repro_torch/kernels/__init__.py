"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

- ``quantize``: blockwise int8 quantization and dequantization
  (``csrc/quantize.cu``, ``csrc/dequantize.cu``).
- ``wire``: the compressed outer exchange's wire packing and per-source
  reductions, plain PyTorch around the (de)quantize wrappers.
- ``flash_attention``: attention forward (prefill, training) and backward
  (training), ``csrc/flash_attention.cu``.
- ``decode_attention``: paged single-query attention of every decode step
  (``csrc/decode_attention.cu``).
- ``pier_update``: the fused outer Nesterov/SGD update of every outer sync
  (``csrc/pier_update.cu``).
- ``rmsnorm``: RMSNorm forward (every norm of an RMSNorm model: block,
  final, qk-norm) and backward (training), ``csrc/rmsnorm.cu``.
- ``ring_allreduce``: the int8 wire's exchange between processes, the ring
  all-gather and shard-scatter kernels (``csrc/ring_allgather.cu``,
  ``csrc/shard_scatter.cu``) over the symmetric buffers of ``symm``
  (``csrc/ipc.cu``: CUDA IPC).

Each wrapper launches its kernel for CUDA tensors and takes the plain
version in ``ref.py`` for CPU tensors; ``_build`` compiles the sources with
``nvcc`` at first use. Importing this package builds nothing.
"""
