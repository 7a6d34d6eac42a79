"""PyTorch/CUDA port of the ECG solver (the JAX package ``repro`` is the reference).

The layout mirrors ``src/repro`` module for module.  Plain tensor code is
PyTorch; the three kernels of the sequential classic-ECG path (Block-ELL
SpMBV, fused Gram product, fused X/R/Z tail) are CUDA C++ for Hopper under
``repro_torch/kernels/csrc``.  A kernel op launches its kernel on a CUDA
tensor and runs its plain torch version on a CPU tensor; entry points take a
``device`` that defaults to ``"cuda"``.

    from repro_torch.sparse import dg_laplace_2d
    from repro_torch.solver import ECGSolver, SolverConfig, KernelConfig

    a = dg_laplace_2d((64, 64), block=16, device="cuda")
    solver = ECGSolver.build(a, config=SolverConfig(
        t=8, kernel=KernelConfig(backend="pallas")), device="cuda")
    res = solver.solve(b)
"""
