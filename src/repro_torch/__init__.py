"""PyTorch port of the cache-based multi-query optimizer (``repro``).

The relational MQO engine runs on a CUDA device by default: scans put
columns on the card, predicate masks come from the hand-written CUDA
kernels in :mod:`repro_torch.kernels.filter_project`, and every other
operator is plain torch.  Module paths, class names and config fields
mirror the JAX package so a reader finds each module's counterpart.
"""
