"""Math kernels: GF(2^8) / Reed-Solomon, the GF(2) XOR schedule of the
bitmatrix codes, CRC32C and CRUSH straw2.

Each device function ships in two forms, chosen by the device of the
tensor it is given:
- a hand-written CUDA kernel (``csrc/``, launched through ``kernels.py``)
  for a CUDA tensor;
- a plain PyTorch version (``*_plain``) for a CPU tensor, which the CPU
  tests hold bit-exact against the JAX package.
``gf8`` is the host-side field arithmetic and matrix construction.
"""
