"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (counterparts of ``repro.kernels``): ``renewal_scan``,
``flash_attention`` and ``ssd_scan``, with ``ops`` (model layout); and
``causal_conv`` and ``gate_norm``, the Mamba2 mixer's conv and gated norm,
and ``rms_norm``, the models' RMSNorm, which have no counterpart there (XLA
fuses those chains)."""
