"""repro_torch.kernels — the hand-written Hopper kernels of the port and
their plain PyTorch versions.

* ``fused_guard``   — one-pass guard statistics (CUDA C++,
                      ``csrc/fused_guard.cu``), replacing
                      ``repro.kernels.fused_guard.fused_guard_pallas``
* ``robust_reduce`` — the filtered mean ξ (CUDA C++,
                      ``csrc/filtered_mean.cu``), replacing
                      ``repro.kernels.robust_reduce.filtered_mean_pallas``
* ``ref``           — the plain PyTorch versions
* ``ops``           — dispatch by the tensor's device: a CUDA tensor
                      launches the kernel (or raises), a CPU tensor runs
                      the plain version
* ``_build``        — builds ``csrc/*.cu`` with ``nvcc`` on first use
* ``gradgen``       — threefry-2x32 and the generated problem's terms

Nothing here builds or imports a GPU toolchain at import time.
"""
