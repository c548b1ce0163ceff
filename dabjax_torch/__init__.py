"""dabjax_torch — the dabjax DAB/DAB+ receiver on PyTorch and CUDA.

A port of the ``dabjax`` device path (acquisition, OFDM demod, FIC and MSC
decode, the block ``Receiver``) to torch tensors, with the Viterbi decoder
as hand-written CUDA kernels for Hopper (``csrc/viterbi.cu``).  The numpy
host plane (constants, tables, FIB parsing, audio, data services, sources)
is imported from ``dabjax``, which stays the reference implementation.
This package never imports jax.
"""

__version__ = "0.1.0"
