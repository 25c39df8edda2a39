"""sdr_tpu — an accelerator SDR link-simulation framework.

A from-scratch JAX/XLA re-design of the capabilities of the
erithion/SDR reference library (header-only C++ FFT / 16-QAM / OFDM
loopback stack), extended into a full link simulator:

- ``sdr_tpu.ops``      — reference-contract signal ops (FFT/IFFT, OFDM
  cyclic prefix, QAM mapping BPSK..1024QAM, AWGN/fading channels,
  ZF/MMSE equalizers, max-log LLR soft demapper).
- ``sdr_tpu.kernels``  — the matmul-DFT FFT backend.
- ``sdr_tpu.link``     — end-to-end jitted link pipelines and BER harness.
- ``sdr_tpu.parallel`` — device-mesh sharding: channel-batch data
  parallelism and time-block sequence parallelism with halo exchange.
- ``sdr_tpu.obs``      — throughput/roofline reporters, profiling hooks.
- ``sdr_tpu.utils``    — host-side utilities (sliding buffer parity with
  the reference's utils::sliding_buffer).

Everything on the compute path is pure-functional, jittable, vmappable
and shardable. Reference semantics (FFT scaling, CP layout, Gray tables,
normalization) follow /root/reference/lib/inc/{fft,ofdm,modulation}.hpp
and are validated bound-exactly by tests/.
"""

__version__ = "0.1.0"

from sdr_tpu.core.config import (  # noqa: F401
    Modulation,
    OFDMConfig,
    ChannelConfig,
    LinkConfig,
)
