"""repro_torch.kernels — the hand-written Hopper kernels of the port and
their plain PyTorch versions.

* ``fused_guard``   — one-pass guard statistics (CUDA C++,
                      ``csrc/fused_guard.cu``), replacing
                      ``repro.kernels.fused_guard.fused_guard_pallas``,
                      its sanitizing variant included
* ``robust_reduce`` — the filtered mean ξ (CUDA C++,
                      ``csrc/filtered_mean.cu``), replacing
                      ``repro.kernels.robust_reduce.filtered_mean_pallas``
                      with and without ``sanitize``;
                      the coordinate median and trimmed mean
                      (``csrc/sorted_reduce.cu``), replacing
                      ``coordinate_median_pallas``/``trimmed_mean_pallas``
* ``pairdist``      — the worker Gram matrix (CUDA C++, ``csrc/gram.cu``),
                      replacing ``repro.kernels.pairdist.gram_pallas``
* ``countsketch``   — the dp_sketch guard's CountSketch (CUDA C++,
                      ``csrc/countsketch.cu``), replacing
                      ``repro.kernels.countsketch.countsketch_pallas``
* ``ref``           — the plain PyTorch versions
* ``ops``           — dispatch by the tensor's device: a CUDA tensor
                      launches the kernel (or raises), a CPU tensor runs
                      the plain version
* ``_build``        — builds ``csrc/*.cu`` with ``nvcc`` on first use
* ``gradgen``       — threefry-2x32 and the generated problem's terms

Nothing here builds or imports a GPU toolchain at import time.
"""
