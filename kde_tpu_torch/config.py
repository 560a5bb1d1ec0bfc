"""Routing gates of the port (ports ``kde_tpu/config.py:21-33``).

The values are the JAX package's: they are routing semantics (which path a
given problem size takes), so the two packages route alike and the tests
compare like with like.  They were tuned for a TPU and are still to be
re-measured on the H100.  Tests monkeypatch them as module attributes.
"""

# Above this many query*component pairs, evaluation stops materializing the
# [M, N] logit matrix: float32 Euclidean densities take the tiled route
# (ops/tiled_eval.py), everything else chunks the query axis.
DIRECT_PAIR_LIMIT: int = 1 << 24

# Above this many N*N pairs per dimension, the LOOCV entropy stops
# materializing the [d, N, N] logits and takes the tiled route (float32) or
# query chunks (float64); see ops/loocv.py::select_loo_impl.
LOOCV_PAIR_LIMIT: int = 1 << 28

# Query-block size of the chunked LOO entropy path.
LOOCV_CHUNK: int = 1024
