"""The Heavens et al. (2017) kNN evidence of one long chain, written plainly.

``knn_evidence.py``'s whitening (imported) and estimator (restated), with
only the blocking of the exhaustive float64 neighbour search changed, so
that a 2^20-row chain takes a few large blocks and not thousands of small
ones: the block's query rows are sized from the card's free memory (taken
after the program's memory is released), and their distance ranks are
formed into ONE preallocated buffer.  In each block:

  rank_ij = [x_i, 1] . [-2 x_j, |x_j|^2]  (the matrix identity in f64,
                                          less the row's constant |x_i|^2,
                                          as one product)
  the row's own column set to +inf
  the minimum of each group of 1024 columns, the 7 groups of the smallest
  minima, and the 7 smallest ranks among those groups' columns (each of
  the row's 7 nearest lies in a group whose minimum is at most its rank,
  so among the 7 groups of smallest minima, up to ties of equal rank)
  those candidates measured again by differences and sorted

Two passes over each block's ranks (the product and the minima): ~3 s
each a 2^20-row chain on an H100, where a top-k over all 2^20 columns of
a row took ~70 s and ``addmm`` with |x_j|^2 broadcast 10.5 s.

Independent of the program: it shares no code with it.
"""

import math

import numpy as np
import torch

from reference.knn_evidence import whiten

FREE_SHARE = 0.5          # of the card's free memory for the rank buffer
CPU_BLOCK_BYTES = 1 << 28  # the rank buffer off the card
GROUP = 1024              # columns a first-stage selection group
SPARE = 3                 # candidates beyond kmax-1, as knn_evidence.py


def block_rows(n, ncols, device):
    """Query rows a block: the rank buffer (rows, ncols) f64 within
    ``FREE_SHARE`` of the card's free memory (``CPU_BLOCK_BYTES`` on the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = int(free * FREE_SHARE)
    else:
        budget = CPU_BLOCK_BYTES
    return max(1, min(n, budget // (8 * ncols)))


def neighbour_distances(x, kmax, device):
    """(n, kmax) distances: column 0 the row itself (0), column k its k-th
    nearest other row, by an exhaustive float64 search."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    xs = torch.as_tensor(np.asarray(x, np.float64), device=device)
    n, d = xs.shape
    keep = min(kmax - 1 + SPARE, n - 1)
    group = min(GROUP, n)
    ngroups = -(-n // group)
    ncols = ngroups * group
    # padded columns: zero coordinates with an infinite |x|^2, never kept
    pad = torch.zeros((ncols - n, d), dtype=xs.dtype, device=device)
    sq = torch.cat([(xs * xs).sum(1),
                    torch.full((ncols - n,), math.inf, dtype=xs.dtype,
                               device=device)])
    ref_t = torch.cat([-2.0 * torch.cat([xs, pad]), sq[:, None]],
                      1).T.contiguous()
    q_aug = torch.cat([xs, torch.ones((n, 1), dtype=xs.dtype,
                                      device=device)], 1)
    block = block_rows(n, ncols, device)
    buf = torch.empty((block, ncols), dtype=xs.dtype, device=device)
    lanes = torch.arange(group, device=device)[None, None, :]
    out = torch.zeros((n, kmax), dtype=xs.dtype, device=device)
    for i0 in range(0, n, block):
        q = xs[i0:i0 + block]
        b = q.shape[0]
        rank = buf[:b]
        torch.mm(q_aug[i0:i0 + b], ref_t, out=rank)
        rows = torch.arange(b, device=device)
        rank[rows, i0 + rows] = math.inf
        gmin = rank.view(b, ngroups, group).amin(dim=2)
        top = torch.topk(gmin, min(keep, ngroups), dim=1, largest=False,
                         sorted=False).indices
        cols = (top[:, :, None] * group + lanes).view(b, -1)
        pick = torch.topk(torch.gather(rank, 1, cols), keep, dim=1,
                          largest=False, sorted=False).indices
        cand = torch.gather(cols, 1, pick)
        diff = q[:, None, :] - xs[cand]
        exact = torch.sort((diff * diff).sum(-1), dim=1).values
        out[i0:i0 + b, 1:] = torch.sqrt(exact[:, :kmax - 1])
    return out.cpu().numpy()


def log_evidence(theta, lnl, weights, kmax, device, sumw=None,
                 prior_volume=1.0):
    """ln Z for k = 1..kmax-1 of one chain in auto mode, as
    ``knn_evidence.log_evidence``.  ``lnl`` is +lnL; ``sumw`` the sum of
    the adjusted weights (default: of ``weights``)."""
    theta = np.asarray(theta, np.float64)
    lnl = np.asarray(lnl, np.float64)
    w = np.asarray(weights, np.float64)
    n, d = theta.shape
    s, log_j = whiten(theta)
    dist = neighbour_distances(s, kmax, device)
    sumw = float(np.sum(w)) if sumw is None else float(sumw)
    lmax = float(np.max(lnl))
    fs = np.exp(lnl - lmax) / w
    unit_ball = math.pi ** (d / 2.0) / math.gamma(1.0 + d / 2.0)
    out = np.empty(kmax - 1)
    for k in range(1, kmax):
        vol = unit_ball * dist[:, k] ** d
        amax = float(np.dot(vol, fs)) / (n * k + 1.0)
        out[k - 1] = (math.log(sumw) + math.log(amax) + log_j + lmax
                      - math.log(prior_volume))
    return out
