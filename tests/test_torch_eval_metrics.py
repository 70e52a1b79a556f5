"""The port's evaluators against the JAX package's, on the CPU, on the same
annotations and files: the rotated overlaps of the detection AP (within
1e-5), `get_official_eval_result` (AP values within 1e-4 and the same
text), CLEAR-MOT on a tracking tree (every metric equal) and the recall
counters of the detection step (exact).

The port's overlaps run `ops.rotated_iou` in torch on the device given
(the CPU here), the JAX package's its jitted twin on the CPU; their
float32 intersection areas agree to rounding, which is all the 1e-5
allows.
"""

import logging
import os

import numpy as np
import pytest
import torch

from jmodt_tpu.eval import clear_mot as jax_clear_mot
from jmodt_tpu.eval import detection_ap as jax_ap
from jmodt_tpu.models.inference import make_recall_fn as jax_make_recall_fn
from jmodt_torch.eval import clear_mot, detection_ap
from jmodt_torch.models.inference import make_recall_fn

logger = logging.getLogger('torch_eval_metrics')
logger.addHandler(logging.NullHandler())
IOU_TOL = 1e-5
AP_TOL = 1e-4


def _bev_boxes(rng, n, spread=6.0):
    return np.stack([rng.uniform(-spread, spread, n),
                     rng.uniform(-spread, spread, n),
                     rng.uniform(1.0, 4.5, n), rng.uniform(1.0, 2.0, n),
                     rng.uniform(-np.pi, np.pi, n)], 1)


@pytest.mark.parametrize('criterion', [-1, 0, 1, 2])
def test_rotate_iou_eval_matches_jax(criterion):
    rng = np.random.RandomState(criterion + 5)
    a, b = _bev_boxes(rng, 37), _bev_boxes(rng, 45)
    b[:10] = a[:10]
    b[10:20] = a[10:20] + rng.normal(0, 0.3, (10, 5))
    want = jax_ap.rotate_iou_eval(a, b, criterion)
    got = detection_ap.rotate_iou_eval(a, b, criterion, device='cpu')
    assert got.shape == want.shape == (37, 45)
    assert (want > 0.05).sum() > 20
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=IOU_TOL * max(np.abs(want).max(), 1.0))
    empty = detection_ap.rotate_iou_eval(a[:0], b, criterion, device='cpu')
    assert empty.shape == (0, 45)


def test_d3_box_overlap_matches_jax():
    rng = np.random.RandomState(1)
    n = 30
    boxes = np.stack([rng.uniform(-5, 5, n), rng.uniform(1.4, 1.8, n),
                      rng.uniform(5, 15, n), rng.uniform(3.5, 4.5, n),
                      rng.uniform(1.4, 1.7, n), rng.uniform(1.5, 1.8, n),
                      rng.uniform(-np.pi, np.pi, n)], 1)
    q = boxes + rng.normal(0, 0.3, boxes.shape)
    for criterion in (-1, 0, 1):
        want = jax_ap.d3_box_overlap(boxes, q, criterion)
        got = detection_ap.d3_box_overlap(boxes, q, criterion, device='cpu')
        assert (want > 0.1).sum() >= n
        np.testing.assert_allclose(got, want, rtol=0, atol=IOU_TOL)


def _anno(rng, boxes, scores=None, names=None):
    """A KITTI anno dict; boxes (N, 7) [x, y, z, h, w, l, ry]."""
    n = len(boxes)
    x, z = boxes[:, 0], boxes[:, 2]
    u = 620 + 720 * x / z
    hpx = 720 * boxes[:, 3] / z
    return {
        'name': np.array(names if names is not None else ['Car'] * n),
        'truncated': rng.choice([0.0, 0.0, 0.3, 0.6], n),
        'occluded': rng.choice([0, 0, 1, 2], n),
        'alpha': (np.full(n, -10.0) if scores is None
                  else rng.uniform(-np.pi, np.pi, n)),
        'bbox': np.stack([u - hpx, 190 - hpx, u + hpx, 190 + 0.2 * hpx], 1),
        'dimensions': boxes[:, [5, 3, 4]],
        'location': boxes[:, 0:3],
        'rotation_y': boxes[:, 6],
        'score': np.zeros(n) if scores is None else scores,
    }


def _annos(seed, n_frames=40):
    """gt and dt annos: noisy matches, misses, false positives, Vans,
    Pedestrians and DontCares, with scores so the 41 recall points are
    all reached."""
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    for _ in range(n_frames):
        k = rng.randint(2, 6)
        g = np.stack([rng.uniform(-8, 8, k), rng.uniform(1.5, 1.8, k),
                      rng.uniform(6, 45, k), rng.uniform(1.4, 1.7, k),
                      rng.uniform(1.5, 1.8, k), rng.uniform(3.5, 4.5, k),
                      rng.uniform(-np.pi, np.pi, k)], 1)
        names = rng.choice(['Car', 'Car', 'Car', 'Van', 'Pedestrian',
                            'DontCare'], k)
        gts.append(_anno(rng, g, names=names))
        keep = rng.rand(k) < 0.85
        d = g[keep] + rng.normal(0, 0.15, (keep.sum(), 7))
        fp = rng.randint(0, 3)
        d = np.concatenate([d, np.stack(
            [rng.uniform(-8, 8, fp), rng.uniform(1.5, 1.8, fp),
             rng.uniform(6, 45, fp), np.full(fp, 1.5), np.full(fp, 1.6),
             np.full(fp, 3.9), rng.uniform(-3, 3, fp)], 1)])
        dts.append(_anno(rng, d, scores=rng.uniform(0.05, 1.0, len(d))))
    return gts, dts


@pytest.mark.parametrize('cls', ['Car', 'Pedestrian'])
def test_official_eval_result_matches_jax(cls):
    gts, dts = _annos(3)
    text_j, ap_j = jax_ap.get_official_eval_result(gts, dts, cls)
    text_t, ap_t = detection_ap.get_official_eval_result(gts, dts, cls,
                                                         device='cpu')
    assert text_t == text_j
    assert ap_t.keys() == ap_j.keys()
    for k in ap_j:
        assert abs(ap_t[k] - ap_j[k]) <= AP_TOL, k
    if cls == 'Car':
        assert 0 < ap_t['Car_3d_moderate'] < 100 and 'aos  AP' in text_t


def test_evaluate_detections_files_match_jax(tmp_path):
    gts, dts = _annos(4, n_frames=6)
    for sub, annos in (('gt', gts), ('dt', dts)):
        os.makedirs(tmp_path / sub)
        for i, a in enumerate(annos):
            with open(tmp_path / sub / ('%06d.txt' % i), 'w') as f:
                for j in range(len(a['name'])):
                    l, h, w = a['dimensions'][j]
                    f.write('%s %.2f %d %.2f %.2f %.2f %.2f %.2f %.2f %.2f '
                            '%.2f %.2f %.2f %.2f %.2f%s\n' % (
                                a['name'][j], a['truncated'][j],
                                a['occluded'][j], a['alpha'][j],
                                *a['bbox'][j], h, w, l, *a['location'][j],
                                a['rotation_y'][j],
                                ' %.4f' % a['score'][j] if sub == 'dt'
                                else ''))
    args = (str(tmp_path / 'gt'), str(tmp_path / 'dt'), list(range(6)))
    text_j, ap_j = jax_ap.evaluate_detections(*args, score_thresh=0.2)
    text_t, ap_t = detection_ap.evaluate_detections(*args, score_thresh=0.2,
                                                    device='cpu')
    assert text_t == text_j
    for k in ap_j:
        assert abs(ap_t[k] - ap_j[k]) <= AP_TOL, k


def test_detection_ap_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    b = _bev_boxes(np.random.RandomState(0), 3)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        detection_ap.rotate_iou_eval(b, b)


# ---------------------------------------------------------------- CLEAR-MOT

def _mot_row(frame, tid, box, obj='Car', trunc=0, occ=0):
    x1, y1, x2, y2 = box
    return (f'{frame} {tid} {obj} {trunc} {occ} -1.5 {x1:.2f} {y1:.2f} '
            f'{x2:.2f} {y2:.2f} 1.5 1.6 3.9 0.0 1.6 10.0 0.1\n')


@pytest.fixture
def mot_tree(tmp_path):
    """Two validation sequences: gt tracks with Vans, a DontCare area and
    an occluded car; results with an id switch, a fragment, a false
    positive and a miss."""
    rng = np.random.RandomState(9)
    gt_dir = tmp_path / 'gt' / 'label_02'
    res_dir = tmp_path / 'results' / 'sha' / 'val'
    os.makedirs(gt_dir)
    os.makedirs(res_dir)
    seqmap = {}
    for seq, n in (('0000', 12), ('0002', 9)):
        gt, res = [], []
        for f in range(n):
            for k in range(4):
                box = (100 + 250 * k + 4 * f, 120, 170 + 250 * k + 4 * f,
                       200 + 10 * k)
                obj = 'Van' if k == 3 else 'Car'
                gt.append(_mot_row(f, k + 1, box, obj, occ=int(k == 2)))
                if (k == 1 and f == 5) or (seq == '0002' and k == 0
                                           and f < 2):
                    continue                           # a miss
                tid = k + 10 + (5 if k == 0 and f >= 7 else 0)  # a switch
                jit = rng.normal(0, 2, 4)
                res.append(_mot_row(f, tid, tuple(np.add(box, jit))))
            gt.append(_mot_row(f, -1, (900, 0, 1000, 80), 'DontCare'))
            if f % 4 == 1:
                res.append(_mot_row(f, 99, (600, 300, 660, 360)))  # FP
        (gt_dir / f'{seq}.txt').write_text(''.join(gt))
        (res_dir / f'{seq}.txt').write_text(''.join(res))
        seqmap[seq] = n
    return tmp_path, seqmap


def test_clear_mot_matches_jax(mot_tree):
    root, seqmap = mot_tree
    evals = []
    for mod in (jax_clear_mot, clear_mot):
        e = mod.TrackingEvaluation(
            t_sha='sha', result_root=str(root / 'results'), part='val',
            gt_path=str(root / 'gt'), seqmap=seqmap)
        assert e.load_tracker(logger) and e.load_groundtruth(logger)
        assert e.compute_metrics(logger)
        evals.append(e)
    a, b = evals
    assert b.id_switches > 0 and b.fp > 0 and b.fn > 0 and b.fragments > 0
    for k, v in vars(a).items():
        if isinstance(v, (int, float, str, bool)):
            assert getattr(b, k) == v, k
    assert a.create_summary() == b.create_summary()
    mota = [mod.evaluate('sha', str(root / 'results'), 'val',
                         str(root / 'gt'), logger, seqmap=seqmap)
            for mod in (jax_clear_mot, clear_mot)]
    assert mota[0] == mota[1] == b.MOTA


# ---------------------------------------------------------------- recall

def _recall_frame(seed, m=16, g=6):
    rng = np.random.RandomState(seed)
    gt = np.zeros((8, 7), np.float32)
    gt[:g] = np.stack([rng.uniform(-8, 8, g), rng.uniform(1.5, 1.8, g),
                       rng.uniform(6, 40, g), rng.uniform(1.4, 1.7, g),
                       rng.uniform(1.5, 1.8, g), rng.uniform(3.5, 4.5, g),
                       rng.uniform(-3, 3, g)], 1)
    src = gt[rng.randint(0, g, m)]
    noise = rng.normal(0, 1.0, (m, 7)) * np.array(
        [0.3, 0.05, 0.3, 0.05, 0.05, 0.1, 0.1])
    pred = (src + noise * rng.uniform(0, 2, (m, 1))).astype(np.float32)
    rois = (src + 2 * noise).astype(np.float32)
    roi_mask = rng.rand(m) < 0.8
    return gt, pred, rois, roi_mask


def test_recall_counts_match_jax():
    jfn = jax_make_recall_fn(max_gt=8, max_det=16)
    accumulate = make_recall_fn(device='cpu')
    acc_j = np.zeros(11, np.int32)
    acc_t = torch.zeros(11, dtype=torch.int32)
    for seed in range(6):
        gt, pred, rois, roi_mask = _recall_frame(seed)
        det_j = {'pred_boxes_all': pred[None], 'roi_mask': roi_mask[None],
                 'rois': rois[None]}
        det_t = {k: torch.from_numpy(v) for k, v in det_j.items()}
        acc_j = jfn.accumulate(acc_j, det_j, gt)
        acc_t = accumulate(acc_t, det_t, gt)
        assert acc_t.dtype == torch.int32
        np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    acc = acc_t.numpy()
    assert acc[10] == 36 and 0 < acc[4] < acc[0] <= 36
