"""Plain references of the benchmark's circuits, in NumPy and plain PyTorch.

Each ``<circuit>.py`` holds, for the configurations that name it, what a
job's answer must be: it draws the circuit's parameters from the seed
(``draw_params``), works the answer out again from the same inputs the
program gets (``solve``), judges the program's answer by the numbers it
compares (``numbers``, each held to ``LIMITS``), and gives the answer that
the reference itself returns in the program's place (``control_answer``,
the control of the comparison). Nothing here imports JAX, the JAX package
or anything of ``rustqip_tpu_torch``, and nothing reads what the program
made.
"""
