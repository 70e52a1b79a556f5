"""KITTI CLEAR-MOT tracking evaluator (counterpart of
`jmodt_tpu/eval/clear_mot.py`).

Port of reference jmodt/tracking/kitti_evaluate.py (itself the official
KITTI devkit port): per-frame Hungarian association gated at min 2D overlap
0.5, CLEAR-MOT (MOTA/MOTP/MOTAL/MODA/MODP), MT/PT/ML, id switches,
fragmentations, recall/precision/F1/FAR, with the same ignore rules
(truncation/occlusion gates, neighboring classes, DontCare areas).

The reference uses the `munkres` package; here the association is scipy `linear_sum_assignment` on the same gated cost matrix —
identical optima away from exact cost ties.
"""

from __future__ import annotations

import copy
import math
import os
from collections import defaultdict
from typing import List

import numpy as np
from scipy.optimize import linear_sum_assignment

from jmodt_torch.config import TEST_SEQ_ID, TRAIN_SEQ_ID, VALID_SEQ_ID

# per-sequence frame counts of the KITTI tracking training set
# (reference kitti_evaluate.py:28-50)
SEQMAP = {
    '0000': 154, '0001': 447, '0002': 233, '0003': 144, '0004': 314,
    '0005': 297, '0006': 270, '0007': 800, '0008': 390, '0009': 803,
    '0010': 294, '0011': 373, '0012': 78, '0013': 340, '0014': 106,
    '0015': 376, '0016': 209, '0017': 145, '0018': 339, '0019': 1059,
    '0020': 837,
}

_MAX_COST = 1e9


class TData:
    """One KITTI tracking row (reference tData, kitti_evaluate.py:53-95)."""

    def __init__(self):
        self.frame = -1
        self.track_id = -1
        self.obj_type = 'unset'
        self.truncation = -1
        self.occlusion = -1
        self.obs_angle = -10.0
        self.x1 = self.y1 = self.x2 = self.y2 = -1.0
        self.w = self.h = self.l = -1.0
        self.X = self.Y = self.Z = -1000.0
        self.yaw = -10.0
        self.score = -1000.0
        self.ignored = False
        self.valid = False
        self.tracker = -1


def _boxoverlap(a: TData, b: TData, criterion: str = 'union') -> float:
    """2D IoU (or intersection-over-a for DontCare) —
    reference kitti_evaluate.py:372-398."""
    x1, y1 = max(a.x1, b.x1), max(a.y1, b.y1)
    x2, y2 = min(a.x2, b.x2), min(a.y2, b.y2)
    w, h = x2 - x1, y2 - y1
    if w <= 0.0 or h <= 0.0:
        return 0.0
    inter = w * h
    aarea = (a.x2 - a.x1) * (a.y2 - a.y1)
    if criterion == 'a':
        return inter / float(aarea)
    barea = (b.x2 - b.x1) * (b.y2 - b.y1)
    return inter / float(aarea + barea - inter)


class TrackingEvaluation:
    """Reference TrackingEvaluation (kitti_evaluate.py:98-906)."""

    def __init__(self, t_sha: str, result_root: str, part: str,
                 gt_path: str, min_overlap: float = 0.5,
                 max_truncation: int = 0, min_height: int = 25,
                 max_occlusion: int = 2, cls: str = 'car',
                 seqmap: dict = None):
        seqmap = seqmap or SEQMAP
        if part == 'val':
            sequence_id = VALID_SEQ_ID
        elif part == 'train':
            sequence_id = TRAIN_SEQ_ID
        elif part == 'test':
            sequence_id = TEST_SEQ_ID
        else:
            raise ValueError(part)
        self.sequence_name = [s for s in seqmap if s in sequence_id]
        self.n_frames = [int(seqmap[s]) for s in self.sequence_name]
        self.cls = cls
        self.gt_path = os.path.join(gt_path, 'label_02')
        self.t_sha = t_sha
        self.t_path = os.path.join(result_root, t_sha, part)
        self.min_overlap = min_overlap
        self.max_truncation = max_truncation
        self.max_occlusion = max_occlusion
        self.min_height = min_height

        self.n_gt = 0
        self.n_igt = 0
        self.n_tr = 0
        self.n_itr = 0
        self.n_igttr = 0
        self.n_gt_trajectories = 0
        self.n_tr_trajectories = 0
        self.MOTA = self.MOTP = self.MOTAL = self.MODA = 0.0
        self.MODP = 0.0
        self.MODP_t: List[float] = []
        self.recall = self.precision = self.F1 = 0.0
        self.FAR = 0.0
        self.total_cost = 0.0
        self.itp = self.tp = self.fn = self.ifn = self.fp = 0
        self.fragments = 0
        self.id_switches = 0
        self.MT = self.PT = self.ML = 0
        self.gt_trajectories = []
        self.ign_trajectories = []
        self.eval_2d = True
        self.eval_3d = True

    # ---------------- loading ----------------

    def load_tracker(self, logger) -> bool:
        try:
            return self._load_data(self.t_path, loading_groundtruth=False,
                                   logger=logger)
        except IOError:
            return False

    def load_groundtruth(self, logger) -> bool:
        try:
            return self._load_data(self.gt_path, loading_groundtruth=True,
                                   logger=logger)
        except IOError:
            return False

    def _load_data(self, root_dir, logger, loading_groundtruth) -> bool:
        """Reference _loadData (kitti_evaluate.py:232-370)."""
        cls = self.cls
        if 'car' in cls:
            classes = ['car', 'van']
        elif 'pedestrian' in cls:
            classes = ['pedestrian', 'person_sitting']
        else:
            classes = [cls]
        classes.append('dontcare')

        seq_data = []
        n_trajectories = 0
        n_trajectories_seq = []
        eval_2d, eval_3d = True, True
        for seq, s_name in enumerate(self.sequence_name):
            filename = os.path.join(root_dir, '%s.txt' % s_name)
            f_data = [[] for _ in range(self.n_frames[seq])]
            ids = []
            n_in_seq = 0
            id_frame_cache = set()
            with open(filename) as f:
                for line in f:
                    fields = line.strip().split(' ')
                    if len(fields) < 17:
                        continue
                    if not any(s in fields[2].lower() for s in classes):
                        continue
                    t = TData()
                    t.frame = int(float(fields[0]))
                    t.track_id = int(float(fields[1]))
                    t.obj_type = fields[2].lower()
                    t.truncation = int(float(fields[3]))
                    t.occlusion = int(float(fields[4]))
                    t.obs_angle = float(fields[5])
                    t.x1, t.y1 = float(fields[6]), float(fields[7])
                    t.x2, t.y2 = float(fields[8]), float(fields[9])
                    t.h, t.w, t.l = (float(fields[10]), float(fields[11]),
                                     float(fields[12]))
                    t.X, t.Y, t.Z = (float(fields[13]), float(fields[14]),
                                     float(fields[15]))
                    t.yaw = float(fields[16])
                    if t.track_id == -1 and t.obj_type != 'dontcare':
                        continue
                    if t.frame >= len(f_data):
                        f_data += [[] for _ in range(
                            max(500, t.frame - len(f_data) + 1))]
                    id_frame = (t.frame, t.track_id)
                    if id_frame in id_frame_cache and not loading_groundtruth:
                        logger.info(
                            'track ids are not unique for sequence %d: '
                            'frame %d, id %d' % (seq, t.frame, t.track_id))
                        return False
                    id_frame_cache.add(id_frame)
                    f_data[t.frame].append(copy.copy(t))
                    if t.track_id not in ids and t.obj_type != 'dontcare':
                        ids.append(t.track_id)
                        n_trajectories += 1
                        n_in_seq += 1
                    if not loading_groundtruth and eval_2d and \
                            (t.x1 == -1 or t.x2 == -1
                             or t.y1 == -1 or t.y2 == -1):
                        eval_2d = False
                    if not loading_groundtruth and eval_3d and \
                            (t.X == -1000 or t.Y == -1000 or t.Z == -1000):
                        eval_3d = False
            n_trajectories_seq.append(n_in_seq)
            seq_data.append(f_data)

        if not loading_groundtruth:
            self.tracker = seq_data
            self.n_tr_trajectories = n_trajectories
            self.eval_2d = eval_2d
            self.eval_3d = eval_3d
            self.n_tr_seq = n_trajectories_seq
            if self.n_tr_trajectories == 0:
                return False
        else:
            self.dcareas, self.groundtruth = [], []
            for seq_gt in seq_data:
                s_g, s_dc = [], []
                for frame_objs in seq_gt:
                    g = [o for o in frame_objs if o.obj_type != 'dontcare']
                    dc = [o for o in frame_objs if o.obj_type == 'dontcare']
                    s_g.append(g)
                    s_dc.append(dc)
                self.dcareas.append(s_dc)
                self.groundtruth.append(s_g)
            self.n_gt_seq = n_trajectories_seq
            self.n_gt_trajectories = n_trajectories
        return True

    # ---------------- metrics ----------------

    def compute_metrics(self, logger) -> bool:
        """Reference compute3rdPartyMetrics (kitti_evaluate.py:401-806)."""
        self.gt_trajectories = [None] * len(self.groundtruth)
        self.ign_trajectories = [None] * len(self.groundtruth)
        for seq_idx in range(len(self.groundtruth)):
            seq_gt = self.groundtruth[seq_idx]
            seq_dc = self.dcareas[seq_idx]
            seq_tracker = self.tracker[seq_idx]
            seq_trajectories = defaultdict(list)
            seq_ignored = defaultdict(list)
            last_ids = [[], []]
            for f in range(len(seq_gt)):
                g, dc, t = seq_gt[f], seq_dc[f], seq_tracker[f]
                self.n_gt += len(g)
                self.n_tr += len(t)

                cost = np.full((len(g), len(t)), _MAX_COST)
                this_ids = [[], []]
                for row, gg in enumerate(g):
                    this_ids[0].append(gg.track_id)
                    this_ids[1].append(-1)
                    gg.tracker = -1
                    gg.id_switch = 0
                    gg.fragmentation = 0
                    for col, tt in enumerate(t):
                        c = 1 - _boxoverlap(gg, tt)
                        if c <= self.min_overlap:
                            cost[row, col] = c
                    seq_trajectories[gg.track_id].append(-1)
                    seq_ignored[gg.track_id].append(False)

                if len(g) and len(t):
                    rows, cols = linear_sum_assignment(cost)
                    association = list(zip(rows.tolist(), cols.tolist()))
                else:
                    association = []

                tmptp = tmpfp = tmpfn = 0
                tmpc = 0.0
                tmpcs = [0.0] * len(g)
                for row, col in association:
                    c = cost[row, col]
                    if c < _MAX_COST:
                        g[row].tracker = t[col].track_id
                        this_ids[1][row] = t[col].track_id
                        t[col].valid = True
                        self.total_cost += 1 - c
                        tmpc += 1 - c
                        tmpcs[row] = 1 - c
                        seq_trajectories[g[row].track_id][-1] = \
                            t[col].track_id
                        self.tp += 1
                        tmptp += 1
                    else:
                        g[row].tracker = -1
                        self.fn += 1
                        tmpfn += 1

                # ignored tracker detections (kitti_evaluate.py:516-544)
                nignoredtracker = 0
                ignoredtrackers = {}
                for tt in t:
                    ignoredtrackers[tt.track_id] = -1
                    tt_height = abs(tt.y1 - tt.y2)
                    if ((self.cls == 'car' and tt.obj_type == 'van')
                        or (self.cls == 'pedestrian'
                            and tt.obj_type == 'person_sitting')
                        or tt_height <= self.min_height) and not tt.valid:
                        nignoredtracker += 1
                        tt.ignored = True
                        ignoredtrackers[tt.track_id] = 1
                        continue
                    for d in dc:
                        if _boxoverlap(tt, d, 'a') > 0.5 and not tt.valid:
                            tt.ignored = True
                            nignoredtracker += 1
                            ignoredtrackers[tt.track_id] = 1
                            break

                # ignored gt (kitti_evaluate.py:546-586)
                ignoredfn = nignoredtp = nignoredpairs = 0
                for gi, gg in enumerate(g):
                    ignorable = (gg.occlusion > self.max_occlusion
                                 or gg.truncation > self.max_truncation
                                 or (self.cls == 'car'
                                     and gg.obj_type == 'van')
                                 or (self.cls == 'pedestrian'
                                     and gg.obj_type == 'person_sitting'))
                    if gg.tracker < 0 and ignorable:
                        seq_ignored[gg.track_id][-1] = True
                        gg.ignored = True
                        ignoredfn += 1
                    elif gg.tracker >= 0 and ignorable:
                        seq_ignored[gg.track_id][-1] = True
                        gg.ignored = True
                        nignoredtp += 1
                        if ignoredtrackers[gg.tracker] > 0:
                            nignoredpairs += 1
                        tmpc -= tmpcs[gi]

                tmptp -= nignoredtp
                self.itp += nignoredtp
                self.n_gt -= (ignoredfn + nignoredtp)
                self.n_igt += ignoredfn + nignoredtp
                self.n_itr += nignoredtracker
                self.n_igttr += nignoredpairs

                tmpfn += len(g) - len(association) - ignoredfn
                self.fn += len(g) - len(association) - ignoredfn
                self.ifn += ignoredfn
                tmpfp += (len(t) - tmptp - nignoredtracker - nignoredtp
                          + nignoredpairs)
                self.fp += (len(t) - tmptp - nignoredtracker - nignoredtp
                            + nignoredpairs)

                if tmptp < 0 or tmpfn < 0 or tmpfp < 0:
                    raise RuntimeError(
                        f'negative stats: tp={tmptp} fn={tmpfn} fp={tmpfp}')

                # id switches / fragmentations per frame
                # (kitti_evaluate.py:661-675)
                for i, tt in enumerate(this_ids[0]):
                    if tt in last_ids[0]:
                        idx = last_ids[0].index(tt)
                        tid = this_ids[1][i]
                        lid = last_ids[1][idx]
                        if tid != lid and lid != -1 and tid != -1:
                            if g[i].truncation < self.max_truncation:
                                g[i].id_switch = 1
                        if tid != lid and lid != -1:
                            if g[i].truncation < self.max_truncation:
                                g[i].fragmentation = 1
                last_ids = this_ids
                self.MODP_t.append(tmpc / float(tmptp) if tmptp != 0 else 1)

            self.gt_trajectories[seq_idx] = seq_trajectories
            self.ign_trajectories[seq_idx] = seq_ignored

        # trajectory-level MT/PT/ML, id switches, fragments
        # (kitti_evaluate.py:702-766)
        n_ignored_tr_total = 0
        for seq_idx, (seq_trajectories, seq_ignored) in enumerate(
                zip(self.gt_trajectories, self.ign_trajectories)):
            if len(seq_trajectories) == 0:
                continue
            for (track_id, gtraj), ign_g in zip(seq_trajectories.items(),
                                                seq_ignored.values()):
                if all(ign_g):
                    n_ignored_tr_total += 1
                    continue
                if all(v == -1 for v in gtraj):
                    self.ML += 1
                    continue
                last_id = gtraj[0]
                tracked = 1 if gtraj[0] >= 0 else 0
                f = 0
                for f in range(1, len(gtraj)):
                    if ign_g[f]:
                        last_id = -1
                        continue
                    if last_id != gtraj[f] and last_id != -1 \
                            and gtraj[f] != -1 and gtraj[f - 1] != -1:
                        self.id_switches += 1
                        logger.info('ID switch: sequence %d, gt track %s, '
                                    'frame %d' % (seq_idx, track_id, f))
                    if f < len(gtraj) - 1 and gtraj[f - 1] != gtraj[f] \
                            and last_id != -1 and gtraj[f] != -1 \
                            and gtraj[f + 1] != -1:
                        self.fragments += 1
                    if gtraj[f] != -1:
                        tracked += 1
                        last_id = gtraj[f]
                if len(gtraj) > 1 and gtraj[f - 1] != gtraj[f] \
                        and last_id != -1 and gtraj[f] != -1 \
                        and not ign_g[f]:
                    self.fragments += 1
                ratio = tracked / float(len(gtraj) - sum(ign_g))
                if ratio > 0.8:
                    self.MT += 1
                elif ratio < 0.2:
                    self.ML += 1
                else:
                    self.PT += 1

        denom = self.n_gt_trajectories - n_ignored_tr_total
        if denom == 0:
            self.MT = self.PT = self.ML = 0.0
        else:
            self.MT /= float(denom)
            self.PT /= float(denom)
            self.ML /= float(denom)

        if (self.fp + self.tp) == 0 or (self.tp + self.fn) == 0:
            self.recall = self.precision = 0.0
        else:
            self.recall = self.tp / float(self.tp + self.fn)
            self.precision = self.tp / float(self.fp + self.tp)
        self.F1 = (2 * self.precision * self.recall
                   / (self.precision + self.recall)
                   if (self.recall + self.precision) > 0 else 0.0)
        self.FAR = (self.fp / float(sum(self.n_frames))
                    if sum(self.n_frames) else float('nan'))

        if self.n_gt == 0:
            self.MOTA = self.MODA = -float('inf')
        else:
            self.MOTA = 1 - (self.fn + self.fp + self.id_switches) \
                / float(self.n_gt)
            self.MODA = 1 - (self.fn + self.fp) / float(self.n_gt)
        self.MOTP = (self.total_cost / float(self.tp)
                     if self.tp else float('inf'))
        if self.n_gt != 0:
            ids_term = (self.id_switches if self.id_switches == 0
                        else math.log10(self.id_switches))
            self.MOTAL = 1 - (self.fn + self.fp + ids_term) \
                / float(self.n_gt)
        else:
            self.MOTAL = -float('inf')
        self.MODP = (sum(self.MODP_t) / float(sum(self.n_frames))
                     if sum(self.n_frames) else float('nan'))
        return True

    # ---------------- reporting ----------------

    def create_summary(self) -> str:
        """Reference createSummary (kitti_evaluate.py:808-859)."""
        rows = [
            ('Multiple Object Tracking Accuracy (MOTA)', self.MOTA),
            ('Multiple Object Tracking Precision (MOTP)', self.MOTP),
            ('Multiple Object Tracking Accuracy (MOTAL)', self.MOTAL),
            ('Multiple Object Detection Accuracy (MODA)', self.MODA),
            ('Multiple Object Detection Precision (MODP)', self.MODP),
            ('', None),
            ('Recall', self.recall), ('Precision', self.precision),
            ('F1', self.F1), ('False Alarm Rate', self.FAR),
            ('', None),
            ('Mostly Tracked', self.MT), ('Partly Tracked', self.PT),
            ('Mostly Lost', self.ML),
            ('', None),
            ('True Positives', self.tp),
            ('Ignored True Positives', self.itp),
            ('False Positives', self.fp),
            ('False Negatives', self.fn),
            ('Ignored False Negatives', self.ifn),
            ('ID-switches', self.id_switches),
            ('Fragmentations', self.fragments),
            ('', None),
            ('Ground Truth Objects (Total)', self.n_gt + self.n_igt),
            ('Ignored Ground Truth Objects', self.n_igt),
            ('Ground Truth Trajectories', self.n_gt_trajectories),
            ('', None),
            ('Tracker Objects (Total)', self.n_tr),
            ('Ignored Tracker Objects', self.n_itr),
            ('Tracker Trajectories', self.n_tr_trajectories),
        ]
        out = ['tracking evaluation summary'.center(80, '=')]
        for key, val in rows:
            if val is None:
                out.append('')
            elif isinstance(val, int):
                out.append(key.ljust(70) + '%10d' % val)
            elif isinstance(val, float):
                out.append(key.ljust(70) + '%10f' % val)
            else:
                out.append(key.ljust(70) + ('%s' % val).rjust(10))
        out.append('=' * 80)
        return '\n'.join(out)

    def save_stats(self, logger):
        """Reference saveToStats (kitti_evaluate.py:880-906)."""
        summary = self.create_summary()
        logger.info(summary)
        eval_dir = os.path.join(self.t_path, 'eval', self.cls)
        os.makedirs(eval_dir, exist_ok=True)
        with open(os.path.join(eval_dir, f'summary_{self.cls}.txt'),
                  'w') as f:
            print(summary, file=f)
        with open(os.path.join(eval_dir, f'stats_{self.cls}.txt'),
                  'w') as f:
            print('%.6f ' * 21 % (
                self.MOTA, self.MOTP, self.MOTAL, self.MODA, self.MODP,
                self.recall, self.precision, self.F1, self.FAR,
                self.MT, self.PT, self.ML, self.tp, self.fp, self.fn,
                self.id_switches, self.fragments, self.n_gt,
                self.n_gt_trajectories, self.n_tr,
                self.n_tr_trajectories), file=f)
        return (self.MOTA, self.MOTP, self.recall, self.precision, self.F1,
                self.fp, self.fn, self.id_switches)


def evaluate(result_sha: str, result_root: str, part: str, gt_path: str,
             logger, seqmap: dict = None):
    """Entry point (reference kitti_evaluate.py:910-959).  Evaluates car
    (and pedestrian when present); returns the car MOTA."""
    logger.info('Processing Result for KITTI Tracking Benchmark')
    for c in ('car', 'pedestrian'):
        e = TrackingEvaluation(t_sha=result_sha, result_root=result_root,
                               part=part, cls=c, gt_path=gt_path,
                               seqmap=seqmap)
        if not e.load_tracker(logger):
            continue
        logger.info('Evaluate Object Class: %s' % c.upper())
        if not e.load_groundtruth(logger):
            raise ValueError('Ground truth not found.')
        if len(e.groundtruth) != len(e.tracker):
            logger.info('The data does not provide results for every '
                        'sequence.')
            return False
        logger.info('Loaded %d Sequences.' % len(e.groundtruth))
        if e.compute_metrics(logger):
            mota, *_ = e.save_stats(logger)
            return mota
        logger.info('No true positives or false positives at all.')
    return False
