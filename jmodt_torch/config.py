"""Immutable configuration for the PyTorch port of JMODT.

The port's own copy of `jmodt_tpu/config.py`: the same frozen dataclasses,
field names and defaults, so one YAML file or override list configures both
packages identically.  It imports only numpy and the standard library, and
the port never imports the JAX package, not even for this.

`config_from_yaml` / `config_from_overrides` replace `cfg_from_file` /
`cfg_from_list` (reference jmodt/config.py:220-276) with the same strict
key/type checking, but return a *new* config instead of mutating a global.
"""

from __future__ import annotations

import dataclasses
import os
from ast import literal_eval
from dataclasses import dataclass, field, fields, replace
from typing import Any, Mapping, Sequence, Tuple

import numpy as np

# Data splits (reference jmodt/config.py:8-11).
TRAIN_SEQ_ID = ('0001', '0003', '0004', '0006', '0013', '0008', '0009', '0012', '0015', '0020')
VALID_SEQ_ID = ('0000', '0002', '0005', '0007', '0010', '0011', '0014', '0016', '0018', '0019')
TEST_SEQ_ID = tuple('%04d' % seq for seq in range(29))
SMALL_VAL_SEQ_ID = ('0019',)


@dataclass(frozen=True)
class LIFusionConfig:
    """Camera-LiDAR fusion (reference jmodt/config.py:44-52)."""
    ENABLED: bool = True
    IMG_FEATURES_CHANNEL: int = 128
    IMG_CHANNELS: Tuple[int, ...] = (3, 64, 128, 256, 512)
    POINT_CHANNELS: Tuple[int, ...] = (96, 256, 512, 1024)
    DeConv_Reduce: Tuple[int, ...] = (16, 16, 16, 16)
    DeConv_Kernels: Tuple[int, ...] = (2, 4, 8, 16)
    DeConv_Strides: Tuple[int, ...] = (2, 4, 8, 16)
    # eval-only fused pyramid->gather in the JAX package; its eval mode is
    # still to be ported, so the port always takes the materialize-then-
    # sample path (the default)
    FUSED_PYRAMID: bool = False


@dataclass(frozen=True)
class SAConfig:
    """Set-abstraction stack for the RPN backbone (reference jmodt/config.py:74-81)."""
    NPOINTS: Tuple[int, ...] = (4096, 1024, 256, 64)
    RADIUS: Tuple[Tuple[float, ...], ...] = ((0.1, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0))
    NSAMPLE: Tuple[Tuple[int, ...], ...] = ((16, 32), (16, 32), (16, 32), (16, 32))
    MLPS: Tuple[Tuple[Tuple[int, ...], ...], ...] = (
        ((16, 16, 32), (32, 32, 64)),
        ((64, 64, 128), (64, 96, 128)),
        ((128, 196, 256), (128, 196, 256)),
        ((256, 256, 512), (256, 384, 512)),
    )


@dataclass(frozen=True)
class RCNNSAConfig:
    """Set-abstraction stack for the RCNN head (reference jmodt/config.py:133-139)."""
    NPOINTS: Tuple[int, ...] = (128, 32, -1)
    RADIUS: Tuple[float, ...] = (0.2, 0.4, 100.0)
    NSAMPLE: Tuple[int, ...] = (64, 64, 64)
    MLPS: Tuple[Tuple[int, ...], ...] = ((128, 128, 128), (128, 128, 256), (256, 256, 512))


@dataclass(frozen=True)
class RPNConfig:
    """Reference jmodt/config.py:55-97."""
    ENABLED: bool = True
    FIXED: bool = True
    USE_INTENSITY: bool = False
    USE_RGB: bool = False
    LOC_XZ_FINE: bool = True
    LOC_SCOPE: float = 3.0
    LOC_BIN_SIZE: float = 0.5
    NUM_HEAD_BIN: int = 12
    USE_BN: bool = True
    NUM_POINTS: int = 16384
    SA_CONFIG: SAConfig = field(default_factory=SAConfig)
    FP_MLPS: Tuple[Tuple[int, ...], ...] = ((128, 128), (256, 256), (512, 512), (512, 512))
    CLS_FC: Tuple[int, ...] = (128,)
    REG_FC: Tuple[int, ...] = (128,)
    DP_RATIO: float = 0.5
    LOSS_CLS: str = 'SigmoidFocalLoss'
    FG_WEIGHT: float = 15.0
    FOCAL_ALPHA: Tuple[float, float] = (0.25, 0.75)
    FOCAL_GAMMA: float = 2.0
    REG_LOSS_WEIGHT: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    LOSS_WEIGHT: Tuple[float, ...] = (1.0, 1.0)
    NMS_TYPE: str = 'normal'  # normal | rotate
    SCORE_THRESH: float = 0.2
    # JAX training knob (rematerialized SA/FP blocks); unused by the port
    REMAT: bool = True
    # JAX knob (Pallas FPS on the TPU); the port's FPS always launches its
    # kernel (jmodt_torch/csrc/fps.cu) on a CUDA tensor
    USE_PALLAS_FPS: bool = True
    # fused gather->MLP->max eval path (ops/fused_sa.py) for the MSG SA
    # levels with N <= 8192 (levels 1-3; level 0 stays on the plain path)
    FUSED_SA: bool = True
    # whole-level SA kernel (FPS + ball query + gather + MLP + max) for the
    # levels the fused path takes; K5 (jmodt_torch/csrc/sa_level.cu) on a
    # CUDA tensor
    MEGA_SA: bool = False


@dataclass(frozen=True)
class RCNNConfig:
    """Reference jmodt/config.py:100-160."""
    ENABLED: bool = True
    ROI_SAMPLE_JIT: bool = True
    REG_AUG_METHOD: str = 'multiple'
    ROI_FG_AUG_TIMES: int = 0
    USE_RPN_FEATURES: bool = True
    USE_MASK: bool = True
    MASK_TYPE: str = 'seg'
    USE_INTENSITY: bool = False
    USE_DEPTH: bool = True
    USE_SEG_SCORE: bool = False
    POOL_EXTRA_WIDTH: float = 0.2
    USE_RGB: bool = False
    LOC_SCOPE: float = 1.5
    LOC_BIN_SIZE: float = 0.5
    NUM_HEAD_BIN: int = 9
    LOC_Y_BY_BIN: bool = False
    LOC_Y_SCOPE: float = 0.5
    LOC_Y_BIN_SIZE: float = 0.25
    SIZE_RES_ON_ROI: bool = False
    USE_BN: bool = False
    DP_RATIO: float = 0.0
    XYZ_UP_LAYER: Tuple[int, ...] = (128, 128)
    NUM_POINTS: int = 512
    SA_CONFIG: RCNNSAConfig = field(default_factory=RCNNSAConfig)
    # fused gather->MLP->max SA path for RCNN sa_0/sa_1 (ops/fused_sa.py)
    FUSED_SA: bool = True
    CLS_FC: Tuple[int, ...] = (512, 512)
    REG_FC: Tuple[int, ...] = (512, 512)
    LOSS_CLS: str = 'BinaryCrossEntropy'
    FOCAL_ALPHA: Tuple[float, float] = (0.25, 0.75)
    FOCAL_GAMMA: float = 2.0
    CLS_WEIGHT: Tuple[float, ...] = (1.0, 1.0, 1.0)
    CLS_FG_THRESH: float = 0.6
    CLS_BG_THRESH: float = 0.45
    CLS_BG_THRESH_LO: float = 0.05
    REG_FG_THRESH: float = 0.55
    FG_RATIO: float = 0.5
    ROI_PER_IMAGE: int = 64
    HARD_BG_RATIO: float = 0.8
    IOU_LOSS_TYPE: str = 'raw'
    IOU_ANGLE_POWER: int = 1
    SCORE_THRESH: float = 0.2
    NMS_THRESH: float = 0.1


@dataclass(frozen=True)
class REIDConfig:
    """Link / start-end re-identification branches (reference jmodt/config.py:163-171)."""
    ENABLED: bool = True
    FG_THRESH: float = 0.85
    LINK_FC: Tuple[int, ...] = (512, 512)
    SE_FC: Tuple[int, ...] = (512, 512)
    USE_BN: bool = False
    DP_RATIO: float = 0.0
    LOSS_LINK: str = 'L1'
    LOSS_SE: str = 'L1'


@dataclass(frozen=True)
class ModeConfig:
    """Per-mode proposal settings (reference jmodt/config.py:187-217, TRAIN/EVAL/TEST)."""
    SPLIT: str = 'train'
    RPN_PRE_NMS_TOP_N: int = 9000
    RPN_POST_NMS_TOP_N: int = 512
    RPN_NMS_THRESH: float = 0.85
    RPN_DISTANCE_BASED_PROPOSE: bool = True
    BBOX_AVG_BY_BIN: bool = True
    RY_WITH_BIN: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Reference jmodt/config.py:174-198."""
    SPLIT: str = 'train'
    VAL_SPLIT: str = 'small_val'
    FINETUNE: bool = True
    RELOAD_OPTIMIZER: bool = False
    EPOCHS: int = 50
    LR: float = 2e-4
    TMAX: int = 50
    ETA_MIN: float = 0.0
    WEIGHT_DECAY: float = 1e-2
    GRAD_NORM_CLIP: float = 1.0
    RPN_PRE_NMS_TOP_N: int = 9000
    RPN_POST_NMS_TOP_N: int = 512
    RPN_NMS_THRESH: float = 0.85
    RPN_DISTANCE_BASED_PROPOSE: bool = True
    RPN_TRAIN_WEIGHT: float = 1.0
    RCNN_TRAIN_WEIGHT: float = 1.0
    LINK_TRAIN_WEIGHT: float = 1.0
    SE_TRAIN_WEIGHT: float = 1.0
    CE_WEIGHT: float = 5.0
    IOU_LOSS_TYPE: str = 'cls_mask_with_bin'
    BBOX_AVG_BY_BIN: bool = True
    RY_WITH_BIN: bool = False


@dataclass(frozen=True)
class Config:
    """Top-level config mirroring the reference global `cfg` (jmodt/config.py:14-217)."""
    TAG: str = 'default'
    CLASSES: str = 'Car'
    INCLUDE_SIMILAR_TYPE: bool = True

    AUG_DATA: bool = False
    AUG_METHOD_LIST: Tuple[str, ...] = ('rotation', 'scaling', 'flip')
    AUG_METHOD_PROB: Tuple[float, ...] = (1.0, 1.0, 0.5)
    AUG_ROT_RANGE: float = 18.0

    GT_AUG_ENABLED: bool = False
    GT_EXTRA_NUM: int = 15
    GT_AUG_RAND_NUM: bool = True
    GT_AUG_APPLY_PROB: float = 1.0
    GT_AUG_HARD_RATIO: float = 0.6

    PC_REDUCE_BY_RANGE: bool = True
    # x, y, z scope in rect camera coords (reference jmodt/config.py:34-36)
    PC_AREA_SCOPE: Tuple[Tuple[float, float], ...] = ((-40.0, 40.0), (-1.0, 3.0), (0.0, 70.4))
    # mean (h, w, l) anchor for Car (reference jmodt/config.py:38)
    CLS_MEAN_SIZE: Tuple[Tuple[float, float, float], ...] = (
        (1.52563191462, 1.62856739989, 3.88311640418),)

    USE_IOU_BRANCH: bool = False

    # Network compute dtype ('bfloat16' | 'float32'): dense/conv compute
    # runs in it while params, BatchNorm statistics and geometry (FPS, ball
    # query, proposal decode, IoU, NMS) stay float32.  The JMODT_DTYPE env
    # var overrides the default (the CPU tests set float32).
    DTYPE: str = field(
        default_factory=lambda: os.environ.get('JMODT_DTYPE', 'bfloat16'))

    LI_FUSION: LIFusionConfig = field(default_factory=LIFusionConfig)
    RPN: RPNConfig = field(default_factory=RPNConfig)
    RCNN: RCNNConfig = field(default_factory=RCNNConfig)
    REID: REIDConfig = field(default_factory=REIDConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    EVAL: ModeConfig = field(default_factory=lambda: ModeConfig(
        SPLIT='val', RPN_POST_NMS_TOP_N=100, RPN_NMS_THRESH=0.8))
    TEST: ModeConfig = field(default_factory=lambda: ModeConfig(
        SPLIT='test', RPN_POST_NMS_TOP_N=100, RPN_NMS_THRESH=0.8))

    def __post_init__(self):
        # Fail loudly on knobs whose non-default settings are not
        # implemented, instead of silently ignoring them.  Audit of every
        # config field (round 2): the remaining never-read fields (TAG,
        # GT_EXTRA_NUM / GT_AUG_*, LI_FUSION.DeConv_Strides,
        # RPN.REG_LOSS_WEIGHT, RCNN.{MASK_TYPE, USE_SEG_SCORE, CLS_WEIGHT,
        # IOU_ANGLE_POWER}) are dead in the REFERENCE as well — defined in
        # jmodt/config.py but read nowhere (CLS_WEIGHT only matters for the
        # multi-class 'CrossEntropy' RCNN loss, which raises
        # NotImplementedError here exactly like unsupported LOSS_CLS values
        # do in the reference).
        if self.GT_AUG_ENABLED:
            raise NotImplementedError(
                'GT_AUG_ENABLED: ground-truth database augmentation is not '
                'implemented (the reference defines but never reads this '
                'knob either — jmodt/config.py:27)')
        if self.DTYPE not in ('bfloat16', 'float32'):
            raise ValueError(f'DTYPE must be bfloat16|float32, '
                             f'got {self.DTYPE!r}')
        if not self.RCNN.ROI_SAMPLE_JIT:
            raise NotImplementedError(
                'ROI_SAMPLE_JIT=False (offline RCNN training from cached '
                'RoIs, reference kitti_dataset.py:396-424) is not '
                'implemented; RoI sampling always runs inside the jitted '
                'train step here')
        if self.REID.LOSS_LINK != 'L1' or self.REID.LOSS_SE != 'L1':
            raise NotImplementedError(
                'only L1 link/se losses exist (the reference raises '
                'NotImplementedError for anything else too, '
                'train_functions.py:312-319)')

    def mode_cfg(self, mode: str):
        """Dynamic per-mode lookup, replacing the reference `cfg[self.mode]` pattern
        (jmodt/detection/layers/proposal_layer.py:39,67-70)."""
        if mode == 'TRAIN':
            return self.TRAIN
        if mode == 'EVAL':
            return self.EVAL
        if mode == 'TEST':
            return self.TEST
        raise KeyError(f'unknown mode {mode!r}')

    @property
    def mean_size(self) -> np.ndarray:
        return np.asarray(self.CLS_MEAN_SIZE[0], dtype=np.float32)


def _coerce(old: Any, new: Any, key: str) -> Any:
    """Type-checked value replacement (reference _merge_a_into_b, jmodt/config.py:228-255)."""
    if dataclasses.is_dataclass(old):
        if not isinstance(new, Mapping):
            raise ValueError(f'config key {key}: expected mapping, got {type(new)}')
        return _merge(old, new, key)
    if isinstance(old, tuple):
        if not isinstance(new, (list, tuple)):
            raise ValueError(f'config key {key}: expected sequence, got {type(new)}')
        return _tuplify(new)
    if isinstance(old, bool) is not isinstance(new, bool):
        raise ValueError(f'Type mismatch ({type(old)} vs {type(new)}) for config key: {key}')
    if isinstance(old, float) and isinstance(new, (int, float)) and not isinstance(new, bool):
        return float(new)
    if type(old) is not type(new):
        raise ValueError(f'Type mismatch ({type(old)} vs {type(new)}) for config key: {key}')
    return new


def _tuplify(value: Any) -> Any:
    if isinstance(value, (list, tuple)):
        return tuple(_tuplify(v) for v in value)
    return value


def _merge(base: Any, updates: Mapping[str, Any], prefix: str = 'cfg') -> Any:
    valid = {f.name for f in fields(base)}
    changes = {}
    for key, val in updates.items():
        if key not in valid:
            raise KeyError(f'{prefix}.{key} is not a valid config key')
        changes[key] = _coerce(getattr(base, key), val, f'{prefix}.{key}')
    return replace(base, **changes)


def config_from_yaml(filename: str, base: Config | None = None) -> Config:
    """Load a YAML file and merge it over the defaults (reference cfg_from_file,
    jmodt/config.py:220-225)."""
    import yaml
    with open(filename, 'r') as f:
        data = yaml.safe_load(f) or {}
    return _merge(base or Config(), data)


def config_from_overrides(base: Config, kv_list: Sequence[str]) -> Config:
    """Apply dotted-key overrides, e.g. ['RPN.FIXED', 'False'] (reference
    cfg_from_list, jmodt/config.py:258-276)."""
    assert len(kv_list) % 2 == 0, 'override list must be key/value pairs'
    cfg = base
    for key, raw in zip(kv_list[0::2], kv_list[1::2]):
        try:
            value = literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        parts = key.split('.')
        tree: dict = {}
        node = tree
        for p in parts[:-1]:
            node[p] = {}
            node = node[p]
        node[parts[-1]] = value
        cfg = _merge(cfg, tree)
    return cfg
