"""Hand-written Hopper kernels (K1 pdist, K3 precheck, K4 flash-attention
forward and K6 SSD intra-chunk in CUDA C++; K2 GMM step in Triton), their
plain PyTorch versions (``ref``) and the dispatching wrappers (``ops``)."""
import threading

# guards every wrapper's launch counter and its last_route / last_plan
# record: the serving runtime launches from its ingest worker and from
# query callers at once
LAUNCH_MU = threading.Lock()
