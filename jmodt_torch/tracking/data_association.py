"""Discrete assignment solvers (host side).

The counterpart of `jmodt_tpu/tracking/data_association.py`, port of
reference jmodt/tracking/data_association.py, with the same two code paths:

  * `mip_solve` — the CBC mixed-integer program (data_association.py:31-104)
    maximizing det + new + end + link scores under flow conservation.
    scipy.optimize.milp (HiGHS branch-and-bound) solves the identical
    formulation, with no OR-Tools dependency.
  * `hungarian_match` — scipy linear_sum_assignment on the combined affinity
    (data_association.py:107-138).

Both consume a host numpy `link_matrix` already combined on device
(w_app * link + w_iou * iou + w_dis * dist — see tracker.py).  The solvers
stay on host exactly like the reference (its `.cpu().numpy()` at
data_association.py:45).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment, milp
from scipy.optimize import Bounds, LinearConstraint
from scipy.sparse import lil_matrix


def mip_solve(cls_score: np.ndarray, link_matrix: np.ndarray,
              new_score: np.ndarray, end_score: np.ndarray
              ) -> Tuple[List[List[int]], List[int], List[int]]:
    """Maximize sum(det*cls + new + end + link) s.t. flow conservation
    (reference ortools_solve, data_association.py:31-104).

    Variable layout: [y_det (P+D), y_new (P+D), y_end (P+D), y_link (P*D)].
    Constraints (rows):
      pred j:  -y_det[j] + y_end[j] + sum_k y_link[j,k] == 0
      det  k:  -y_det[P+k] + y_new[P+k] + sum_j y_link[j,k] == 0

    :param cls_score: (P+D,) unary det scores (w_cls * (score - 1))
    :param link_matrix: (P, D) combined affinity
    :param new_score: (P+D,) start scores (zeros for the P track slots)
    :param end_score: (P+D,) end scores (zeros for the D det slots)
    :return: (matched [t, d] pairs, unmatched det idxs, tentative det idxs)
    """
    num_pred, num_det = link_matrix.shape
    n_unary = num_pred + num_det
    n_link = num_pred * num_det
    n_var = 3 * n_unary + n_link

    c = -np.concatenate([cls_score, new_score, end_score,
                         link_matrix.reshape(-1)])  # milp minimizes

    a = lil_matrix((n_unary, n_var))
    for j in range(num_pred):
        a[j, j] = -1.0                       # -y_det[j]
        a[j, 2 * n_unary + j] = 1.0          # +y_end[j]
        for k in range(num_det):
            a[j, 3 * n_unary + j * num_det + k] = 1.0
    for k in range(num_det):
        row = num_pred + k
        a[row, row] = -1.0                   # -y_det[P+k]
        a[row, n_unary + row] = 1.0          # +y_new[P+k]
        for j in range(num_pred):
            a[row, 3 * n_unary + j * num_det + k] = 1.0

    res = milp(c=c,
               constraints=LinearConstraint(a.tocsr(), 0.0, 0.0),
               integrality=np.ones(n_var),
               bounds=Bounds(0.0, 1.0))
    x = np.round(res.x).astype(int)

    assign_link = x[3 * n_unary:].reshape(num_pred, num_det)
    assign_det = x[:n_unary]
    assign_new = x[n_unary:2 * n_unary]

    matched = np.argwhere(assign_link > 0).tolist()
    unmatched = np.flatnonzero(assign_new[num_pred:] > 0).tolist()
    tentative = np.flatnonzero(assign_det[num_pred:] == 0).tolist()
    return matched, unmatched, tentative


def hungarian_match(link_matrix: np.ndarray, det_scores: Sequence[float],
                    score_threshold: float = 0.0,
                    match_threshold: float = 0.0
                    ) -> Tuple[List[List[int]], List[int], List[int]]:
    """Hungarian assignment (reference hungarian_match,
    data_association.py:107-138).

    Deviation: the reference tests unmatched detections against `row_ind`
    (track indices) — a latent bug since rows index tracks and columns index
    detections; here detections are correctly tested against `col_ind`.
    """
    row_ind, col_ind = linear_sum_assignment(link_matrix, maximize=True)
    valid = link_matrix[row_ind, col_ind] > match_threshold
    row_ind, col_ind = row_ind[valid], col_ind[valid]

    matched_dets = set(col_ind.tolist())
    unmatched, tentative = [], []
    for d in range(len(det_scores)):
        if d not in matched_dets:
            (unmatched if det_scores[d] > score_threshold
             else tentative).append(d)
    matched = np.stack([row_ind, col_ind], axis=1).tolist()
    return matched, unmatched, tentative
