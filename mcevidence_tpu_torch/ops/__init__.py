from .estimator import log_evidence_from_knn, log_evidence_from_knn_np
from .knn import exact_knn, refine_knn_f64
from .knn_hopper import (knn_select_batched, knn_select_large_k,
                         knn_select_packed, knn_select_prologue,
                         knn_select_small_k, knn_select_smalld,
                         knn_select_torch, knn_select_torch_batched)
from .whiten import (WhitenStats, apply_whiten, covariance, whiten_masked,
                     whiten_stats)
