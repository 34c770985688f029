"""The benchmark's plain reference of the shallow-water run.

It reads a run directory (``basin.par``, ``sw.par``, ``ocean_run.par`` and
the mask and ``ssh init`` files they name) and works out the grid, the
initial state and the model steps itself, in numpy (the grid) and plain
PyTorch (the steps). It imports nothing of the program under test: its
formulas follow the reference Fortran model's kernels as the eager
composition writes them (depth.f90, vel_ssh.f90, leapfrog_tracer.f90).
"""
