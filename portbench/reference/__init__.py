"""The plain reference that decides a run's ``correct``: plain torch and
numpy only, importing nothing of the program under test
(``loupiote_tpu_torch``). Its modules are frozen copies of the port's
plain path (the torch twins of the kernels, the shading, the denoiser),
so a later change to the program does not move them; it builds its own
BVH, atlas and probe tables from the benchmark's inputs.
"""
