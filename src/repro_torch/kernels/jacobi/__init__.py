from .ops import jacobi_solve, jacobi_step
from .ref import jacobi_solve_ref, jacobi_step_ref
