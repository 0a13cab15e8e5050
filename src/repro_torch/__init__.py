"""repro_torch — Xling/XJoin (learned-filter similarity join) on PyTorch + CUDA.

The PyTorch port of `repro`, module for module. It imports torch, numpy
and the standard library only: never `jax`, never anything of `repro`.
The hot functions of the join — the pairwise-distance eps histogram, the
estimator forward, and the probes of the approximate verify (the LSH
member-table gather and the IVF-PQ ADC ranking) — run as hand-written
CUDA kernels (`csrc/*.cu`, built with nvcc at first use) on CUDA
tensors, and as their plain PyTorch versions on CPU tensors.

Every entry point takes an explicit `device=` and defaults to "cuda";
without a GPU it raises unless the caller asked for "cpu".
"""

__version__ = "0.1.0"
