"""The system under test, reached by its module names only, and the
configurations the benchmark builds from a configuration file.

`Program('jmodt_torch')` is the port, the system under test;
`Program('perfbench.reference')` is the plain reference, which has the
same entry points (the control runs it in the program's place)."""

from __future__ import annotations

import importlib
from typing import Any, Dict, List


def flatten(tree: Dict[str, Any], prefix: str = '') -> List[str]:
    """Dotted KEY VALUE pairs of a nested configuration, values as Python
    literals (what `config_from_overrides` reads)."""
    out = []
    for key, value in tree.items():
        if isinstance(value, dict):
            out += flatten(value, f'{prefix}{key}.')
        else:
            out += [f'{prefix}{key}', repr(value)]
    return out


class Program:
    """The modules of a package that has the port's layout."""

    def __init__(self, package: str):
        mod = lambda name: importlib.import_module(f'{package}.{name}')
        self.config = mod('config')
        self.point_rcnn = mod('models.point_rcnn')
        self.rcnn = mod('models.rcnn')
        self.pipeline = mod('pipeline')
        self.tracker = mod('tracking.device_tracker')
        self.train_step = mod('train.train_step')

    def make_config(self, tree: Dict[str, Any], **changes):
        """The package's Config of the nested `tree`, then the top-level
        and dotted `changes` (e.g. {'RPN.MEGA_SA': False})."""
        pairs = flatten(tree)
        for key, value in changes.items():
            pairs += [key, repr(value)]
        return self.config.config_from_overrides(self.config.Config(), pairs)


def plain_changes(dtype: str = 'float32') -> Dict[str, Any]:
    """What the reference changes of a cell's configuration: the image
    pyramid on its materialized path (the reference's SA levels are plain
    whatever the flags say) and the compute dtype."""
    return {'LI_FUSION.FUSED_PYRAMID': False, 'DTYPE': dtype}
