"""Hand-written Pallas GPU kernels (Triton route) — the performance tier.

The jnp blocked sweep (ops/neighbors.py) is a sequential scan that always
processes ``window_cap`` candidate lanes per block row; these kernels run
one program per logical block in parallel and loop only over
``ceil(actual_window / tile)`` j tiles — work proportional to the real
neighborhood.
"""
