"""KITTI dataset pipeline (host side, numpy); the counterpart of
`jmodt_tpu/data/kitti_dataset.py`.

Port of reference jmodt/detection/datasets/kitti_dataset.py.  As in the
JAX package, gt boxes are padded to a fixed `max_gt` a batch instead of the
per-batch max (reference collate, kitti_dataset.py:394-403), so every batch
has one shape.

Points are read, projected and filtered by the port's C++ loader
(`jmodt_torch/native`, the JAX package's `pointcloud.cpp`) by default, as
the JAX package does; with `use_native=False`, or where the library cannot
be built, by `np.fromfile` and the numpy projection.  The two agree within
rtol 2e-4 (float64 against float32; a point on a filter's edge may flip).
A sample is bit-equal to the JAX package's `KittiDataset` with the same
seed and the same `use_native`: the same `np.random.RandomState` draws in
the same order, the same C++ source and flags, or the projection and
filters in numpy with the same dtypes.  The PNGs are read by
`utils/png.py` instead of PIL.

Framework-independent: plain `__len__`/`__getitem__` + `collate_batch`, so it
plugs into `torch.utils.data.DataLoader` (for multi-process prefetch) or a
simple python loop alike.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from jmodt_torch import native
from jmodt_torch.config import Config
from jmodt_torch.utils.calibration import Calibration
from jmodt_torch.utils.object3d import get_objects_from_label
from jmodt_torch.utils.png import png_size, read_png_rgb

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def rotate_pc_along_y(pc: np.ndarray, rot_angle: float) -> np.ndarray:
    """Rotate (N, 3+) points around the y axis (reference
    kitti_utils.rotate_pc_along_y, kitti_utils.py:33-46)."""
    cosval = np.cos(rot_angle)
    sinval = np.sin(rot_angle)
    rotmat = np.array([[cosval, -sinval], [sinval, cosval]])
    pc = pc.copy()
    pc[:, [0, 2]] = pc[:, [0, 2]] @ rotmat.T
    return pc


def in_box3d_mask(pts: np.ndarray, box: np.ndarray,
                  extra: float = 0.0) -> np.ndarray:
    """Points inside a (possibly enlarged) rotated box.  Replaces the
    reference's Delaunay in_hull (kitti_utils.py:165-179) with an exact
    canonical-frame extent test — identical for rectangular boxes."""
    x, y, z, h, w, l, ry = box[:7]
    local = pts - np.array([x, y, z], pts.dtype)
    c, s = np.cos(-ry), np.sin(-ry)
    lx = local[:, 0] * c + local[:, 2] * s
    lz = -local[:, 0] * s + local[:, 2] * c
    return ((np.abs(lx) <= l / 2 + extra) & (np.abs(lz) <= w / 2 + extra)
            & (local[:, 1] <= extra) & (local[:, 1] >= -h - extra))


def generate_rpn_training_labels(pts_rect: np.ndarray,
                                 gt_boxes3d: np.ndarray):
    """Per-point cls/reg labels (reference kitti_dataset.py:304-334)."""
    n = pts_rect.shape[0]
    cls_label = np.zeros(n, np.int32)
    reg_label = np.zeros((n, 7), np.float32)
    for k in range(gt_boxes3d.shape[0]):
        box = gt_boxes3d[k]
        fg = in_box3d_mask(pts_rect, box)
        enlarged = in_box3d_mask(pts_rect, box, extra=0.2)
        cls_label[np.logical_xor(fg, enlarged)] = -1
        cls_label[fg] = 1
        center = box[0:3].copy()
        center[1] -= box[3] / 2  # y becomes the true 3D center
        reg_label[fg, 0:3] = center - pts_rect[fg]
        reg_label[fg, 3:6] = box[3:6]
        reg_label[fg, 6] = box[6]
    return cls_label, reg_label


class KittiDataset:
    """Reference KittiDataset (kitti_dataset.py:12-92).

    :param challenge: 'detection' (object layout) or 'tracking'
        (tracking_object layout written by jmodt_torch.data.converter)
    :param max_gt: fixed gt padding (see the module docstring)
    """

    def __init__(self, root_dir: str, npoints: int = 16384,
                 split: str = 'train', classes: str = 'Car',
                 mode: str = 'TRAIN', logger=None,
                 challenge: str = 'tracking',
                 fixed_img_size=(384, 1280), cfg: Optional[Config] = None,
                 max_gt: int = 32, rpn_labels: Optional[bool] = None,
                 seed: int = 0, use_native: bool = True,
                 raw_uint8_images: bool = False):
        assert mode in ('TRAIN', 'EVAL', 'TEST'), f'invalid mode {mode}'
        self.cfg = cfg or Config()
        self.split = split
        self.mode = mode
        self.challenge = challenge
        self.fixed_img_size = fixed_img_size
        self.npoints = npoints
        self.max_gt = max_gt
        self.logger = logger
        self.rng = np.random.RandomState(seed)
        self.rpn_labels = (not self.cfg.RPN.FIXED if rpn_labels is None
                           else rpn_labels)
        self.use_native = use_native
        # ship raw uint8 images and normalize on the device
        # (models/inference.py): 4x less host-to-device traffic
        self.raw_uint8_images = raw_uint8_images

        is_test = split == 'test'
        sub = 'object' if challenge == 'detection' else 'tracking_object'
        data_dir = os.path.join(root_dir, sub,
                                'testing' if is_test else 'training')
        split_file = os.path.join(root_dir, sub, 'ImageSets', split + '.txt')
        self.image_dir = os.path.join(data_dir, 'image_2')
        self.lidar_dir = os.path.join(data_dir, 'velodyne')
        self.calib_dir = os.path.join(data_dir, 'calib')
        self.label_dir = os.path.join(data_dir, 'label_2')

        if classes == 'Car':
            self.classes = ('Background', 'Car')
        elif classes == 'People':
            self.classes = ('Background', 'Pedestrian', 'Cyclist')
        elif classes == 'Pedestrian':
            self.classes = ('Background', 'Pedestrian')
        elif classes == 'Cyclist':
            self.classes = ('Background', 'Cyclist')
        else:
            raise ValueError(f'invalid classes: {classes}')

        pair_mode = challenge == 'tracking' and mode == 'TRAIN'
        with open(split_file) as f:
            lines = [x.split() for x in f.readlines() if x.strip()]
        if pair_mode:
            # keep pairs where both frames have labels (kitti_dataset.py:73-85)
            pairs = [(int(a), int(b)) for a, b in lines]
            self.sample_pair_id_list = [
                (a, b) for a, b in pairs
                if self.filtrate_objects(self.get_label(a))
                and self.filtrate_objects(self.get_label(b))]
            if logger:
                logger.info('Done filtering: %d / %d pairs'
                            % (len(self.sample_pair_id_list), len(pairs)))
        elif challenge == 'detection' and mode == 'TRAIN':
            ids = [int(x[0]) for x in lines]
            self.sample_id_list = [
                i for i in ids if self.filtrate_objects(self.get_label(i))]
        else:
            self.sample_id_list = [int(x[0]) for x in lines]
        self.pair_mode = pair_mode

    # ---------------- raw readers ----------------

    def get_normalized_image(self, idx: int) -> np.ndarray:
        """Image zero-padded to fixed size (kitti_dataset.py:94-110);
        ImageNet-normalized f32 by default, raw uint8 when
        raw_uint8_images (device-side normalization path)."""
        img_file = os.path.join(self.image_dir, '%06d.png' % idx)
        raw = read_png_rgb(img_file)
        if self.raw_uint8_images:
            fixed = np.zeros((*self.fixed_img_size, 3), np.uint8)
            fixed[:raw.shape[0], :raw.shape[1]] = \
                raw[:self.fixed_img_size[0], :self.fixed_img_size[1]]
            return fixed
        img = raw.astype(np.float32) / 255.0
        img = (img - _IMAGENET_MEAN) / _IMAGENET_STD
        fixed = np.zeros((*self.fixed_img_size, 3), np.float32)
        fixed[:img.shape[0], :img.shape[1]] = \
            img[:self.fixed_img_size[0], :self.fixed_img_size[1]]
        return fixed

    def get_image_shape(self, idx: int):
        img_file = os.path.join(self.image_dir, '%06d.png' % idx)
        h, w = png_size(img_file)
        return h, w, 3

    def get_lidar(self, idx: int) -> np.ndarray:
        lidar_file = os.path.join(self.lidar_dir, '%06d.bin' % idx)
        return np.fromfile(lidar_file, dtype=np.float32).reshape(-1, 4)

    def get_calib(self, idx: int) -> Calibration:
        return Calibration(os.path.join(self.calib_dir, '%06d.txt' % idx))

    def get_label(self, idx: int):
        return get_objects_from_label(
            os.path.join(self.label_dir, '%06d.txt' % idx))

    # ---------------- filters ----------------

    def filtrate_objects(self, obj_list):
        """Class + range filter (kitti_dataset.py:134-155)."""
        whitelist = list(self.classes)
        if self.mode == 'TRAIN' and self.cfg.INCLUDE_SIMILAR_TYPE:
            if 'Car' in whitelist:
                whitelist.append('Van')
            if 'Pedestrian' in whitelist:
                whitelist.append('Person_sitting')
        out = []
        for obj in obj_list:
            if obj.cls_type not in whitelist:
                continue
            if (self.mode == 'TRAIN' and self.cfg.PC_REDUCE_BY_RANGE
                    and not self._in_range(obj.pos)):
                continue
            out.append(obj)
        return out

    def _in_range(self, xyz) -> bool:
        (x0, x1), (y0, y1), (z0, z1) = self.cfg.PC_AREA_SCOPE
        return (x0 <= xyz[0] <= x1 and y0 <= xyz[1] <= y1
                and z0 <= xyz[2] <= z1)

    def _valid_flag(self, pts_rect, pts_img, pts_depth, img_shape):
        """In-image + in-range point filter (kitti_dataset.py:169-192)."""
        flag = ((pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_shape[1])
                & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_shape[0])
                & (pts_depth >= 0))
        if self.cfg.PC_REDUCE_BY_RANGE:
            (x0, x1), (y0, y1), (z0, z1) = self.cfg.PC_AREA_SCOPE
            flag &= ((pts_rect[:, 0] >= x0) & (pts_rect[:, 0] <= x1)
                     & (pts_rect[:, 1] >= y0) & (pts_rect[:, 1] <= y1)
                     & (pts_rect[:, 2] >= z0) & (pts_rect[:, 2] <= z1))
        return flag

    # ---------------- samples ----------------

    def __len__(self):
        return (len(self.sample_pair_id_list) if self.pair_mode
                else len(self.sample_id_list))

    def __getitem__(self, index):
        if self.pair_mode:
            a, b = self.sample_pair_id_list[index]
            return self.get_sample_dict(a), self.get_sample_dict(b)
        return self.get_sample_dict(self.sample_id_list[index])

    def get_sample_dict(self, sample_id: int) -> dict:
        """One frame (reference get_sample_dict, kitti_dataset.py:207-301)."""
        cfg = self.cfg
        calib = self.get_calib(sample_id)
        img = self.get_normalized_image(sample_id)
        img_shape = self.get_image_shape(sample_id)

        loaded = None
        if self.use_native:
            pts_lidar = native.load_velodyne(
                os.path.join(self.lidar_dir, '%06d.bin' % sample_id))
            if pts_lidar is not None:
                loaded = native.project_and_filter(
                    pts_lidar, calib.V2C, calib.R0, calib.P2, img_shape,
                    scope=(cfg.PC_AREA_SCOPE if cfg.PC_REDUCE_BY_RANGE
                           else None))
        if loaded is not None:
            pts_rect, pts_intensity, pts_xy = loaded
        else:
            pts_lidar = self.get_lidar(sample_id)
            pts_rect = calib.lidar_to_rect(pts_lidar[:, 0:3])
            pts_img, pts_depth = calib.rect_to_img(pts_rect)
            valid = self._valid_flag(pts_rect, pts_img, pts_depth,
                                     img_shape)
            pts_rect = pts_rect[valid]
            pts_intensity = pts_lidar[valid, 3]
            pts_xy = pts_img[valid]

        # near/far sampling at 40 m (kitti_dataset.py:231-247)
        if self.npoints < len(pts_rect):
            near = np.flatnonzero(pts_rect[:, 2] < 40.0)
            far = np.flatnonzero(pts_rect[:, 2] >= 40.0)
            if len(far) >= self.npoints:
                # degenerate case the reference cannot hit at npoints=16384:
                # more far points than the whole budget.  Sample uniformly
                # over ALL points — taking only far points would discard
                # every near (typically foreground-bearing) point, which
                # silently zeroes the fg labels in miniature configs
                choice = self.rng.choice(len(pts_rect), self.npoints,
                                         replace=False)
            else:
                near_choice = self.rng.choice(
                    near, self.npoints - len(far), replace=False)
                choice = (np.concatenate((near_choice, far))
                          if len(far) > 0 else near_choice)
        else:
            choice = np.arange(len(pts_rect), dtype=np.int64)
            if len(choice) == 0:
                raise ValueError(
                    'no lidar points survive the image/range filter '
                    '(check calibration vs image size)')
            while self.npoints > len(choice):
                # deviation: the reference pads npoints % len per round
                # (kitti_dataset.py:244-247), which loops forever whenever
                # len divides npoints (e.g. one valid point); padding by
                # the remaining deficit is identical in the non-degenerate
                # len <= npoints < 2*len case and always terminates
                extra = self.rng.choice(
                    choice, min(self.npoints - len(choice), len(choice)),
                    replace=False)
                choice = np.concatenate((choice, extra))
        self.rng.shuffle(choice)

        ret_pts_rect = pts_rect[choice]
        ret_intensity = pts_intensity[choice] - 0.5
        ret_xy = pts_xy[choice].copy()
        h, w = self.fixed_img_size
        ret_xy[:, 0] = ret_xy[:, 0] / (w - 1.0) * 2.0 - 1.0
        ret_xy[:, 1] = ret_xy[:, 1] / (h - 1.0) * 2.0 - 1.0

        sample = {'sample_id': sample_id, 'img': img,
                  'pts_xy': ret_xy.astype(np.float32)}

        if self.mode == 'TEST':
            sample['pts_input'] = (
                np.concatenate([ret_pts_rect, ret_intensity[:, None]], axis=1)
                if cfg.RPN.USE_INTENSITY else ret_pts_rect).astype(np.float32)
            return sample

        gt_objs = self.filtrate_objects(self.get_label(sample_id))
        gt_boxes3d = np.zeros((len(gt_objs), 7), np.float32)
        gt_alpha = np.zeros(len(gt_objs), np.float32)
        gt_tids = np.zeros(len(gt_objs), np.float32)
        for k, obj in enumerate(gt_objs):
            gt_boxes3d[k, 0:3] = obj.pos
            gt_boxes3d[k, 3:7] = (obj.h, obj.w, obj.l, obj.ry)
            gt_alpha[k] = obj.alpha
            gt_tids[k] = obj.score  # converted labels carry tid here

        aug_pts = ret_pts_rect.copy()
        aug_boxes = gt_boxes3d.copy()
        if cfg.AUG_DATA and self.mode == 'TRAIN':
            aug_pts, aug_boxes = self.data_augmentation(
                aug_pts, aug_boxes, gt_alpha)

        sample['pts_input'] = (
            np.concatenate([aug_pts, ret_intensity[:, None]], axis=1)
            if cfg.RPN.USE_INTENSITY else aug_pts).astype(np.float32)
        sample['gt_boxes3d'] = aug_boxes
        sample['gt_tids'] = gt_tids
        if self.rpn_labels:
            cls_label, reg_label = generate_rpn_training_labels(
                aug_pts, aug_boxes)
            sample['rpn_cls_label'] = cls_label
            sample['rpn_reg_label'] = reg_label
        return sample

    def data_augmentation(self, pts, boxes, alpha):
        """rotation / scaling / flip (kitti_dataset.py:349-383)."""
        cfg = self.cfg
        enable = 1 - self.rng.rand(3)
        if 'rotation' in cfg.AUG_METHOD_LIST and \
                enable[0] < cfg.AUG_METHOD_PROB[0]:
            angle = self.rng.uniform(-np.pi / cfg.AUG_ROT_RANGE,
                                     np.pi / cfg.AUG_ROT_RANGE)
            pts = rotate_pc_along_y(pts, angle)
            boxes = rotate_pc_along_y(boxes, angle)
            beta = np.arctan2(boxes[:, 2], boxes[:, 0])
            boxes[:, 6] = np.sign(beta) * np.pi / 2 + alpha - beta
        if 'scaling' in cfg.AUG_METHOD_LIST and \
                enable[1] < cfg.AUG_METHOD_PROB[1]:
            scale = self.rng.uniform(0.95, 1.05)
            pts = pts * scale
            boxes[:, 0:6] = boxes[:, 0:6] * scale
        if 'flip' in cfg.AUG_METHOD_LIST and \
                enable[2] < cfg.AUG_METHOD_PROB[2]:
            pts[:, 0] = -pts[:, 0]
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 6] = np.sign(boxes[:, 6]) * np.pi - boxes[:, 6]
        return pts, boxes

    # ---------------- collate ----------------

    def _pad_gt(self, arr: np.ndarray, width: int = 7) -> np.ndarray:
        out = np.zeros((self.max_gt,) + ((width,) if width else ()),
                       np.float32)
        n = min(len(arr), self.max_gt)
        out[:n] = arr[:n]
        return out

    def collate_batch(self, batch) -> dict:
        """Stack samples; pair mode interleaves (prev, next) as rows
        (2i, 2i+1) (reference collate_batch, kitti_dataset.py:385-457)."""
        if self.pair_mode:
            flat = [fr for pair in batch for fr in pair]
        else:
            flat = batch
        out = {}
        for key in flat[0]:
            vals = [f[key] for f in flat]
            if key == 'gt_boxes3d':
                out[key] = np.stack([self._pad_gt(v, 7) for v in vals])
            elif key == 'gt_tids':
                out[key] = np.stack([self._pad_gt(v, 0) for v in vals])
            elif isinstance(vals[0], np.ndarray):
                out[key] = np.stack(vals)
            elif isinstance(vals[0], int):
                out[key] = np.array(vals, np.int32)
            else:
                out[key] = vals
        return out
