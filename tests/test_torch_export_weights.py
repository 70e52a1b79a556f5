"""Weight export to the reference PointRCNN `.pth`
(`weights.export_reference_state`, `python -m
jmodt_torch.tools.export_torch_weights`) against the JAX package's
`jmodt_tpu/utils/torch_import.py::export_model_state`.

- A port model loaded from a JAX tree exports bit-equal, key for key and
  in the same order, to `export_model_state` of that tree: the fusion
  model at the small config and the lidar-only one (a subset without the
  image and fusion units).
- The export round-trips through `weights.reference_state_to_state_dict`
  into the port's state_dict, bit for bit.
- The CLI's `.pth`, from a checkpoint written by `save_checkpoint` and by
  `AsyncCheckpointWriter`, loads through the JAX package's
  `convert_torch_checkpoint` into the tree the port was built from, with
  its epoch and iteration.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from jmodt_tpu.data import synthetic as jax_synthetic
from jmodt_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from jmodt_tpu.utils.torch_import import (convert_torch_checkpoint,
                                          export_model_state)
from jmodt_torch import config as torch_config
from jmodt_torch.models.point_rcnn import PointRCNN
from jmodt_torch.tools import export_torch_weights
from jmodt_torch.train.checkpoint import (AsyncCheckpointWriter,
                                          checkpoint_state, save_checkpoint)
from jmodt_torch.weights import (export_reference_state, load_jax_variables,
                                 reference_state_to_state_dict)

IMAGE_UNITS = ('Img_Block', 'Fusion_Conv', 'final_fusion', 'DeConv',
               'image_fusion')


def _jax_tree(fusion: bool, seed: int):
    cfg = __graft_entry__._small_config()
    cfg = dataclasses.replace(
        cfg, LI_FUSION=dataclasses.replace(cfg.LI_FUSION, ENABLED=fusion))
    frame = jax_synthetic.make_eval_frame(seed, cfg, img_hw=(64, 128))
    img = frame['img'] if fusion else None
    xy = frame['pts_xy'] if fusion else None
    model = JaxPointRCNN(cfg, mode='EVAL')
    variables = jax.jit(lambda k: model.init(
        k, frame['pts_input'], img, xy, train=False))(
            jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape)
                              .astype(np.float32)),
        variables['batch_stats'])
    tree = jax.device_get({'params': variables['params'],
                           'batch_stats': stats})
    tcfg = torch_config._merge(torch_config.Config(),
                               dataclasses.asdict(cfg))
    return tree, load_jax_variables(PointRCNN(tcfg, device='cpu'), tree,
                                    device='cpu')


@pytest.fixture(scope='module', params=[True, False],
                ids=['fusion', 'lidar_only'])
def built(request):
    return (request.param,) + _jax_tree(request.param, 3)


def test_export_matches_jax_export(built):
    fusion, tree, model = built
    want = export_model_state(tree)
    got = export_reference_state(model)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    has_image = any(u in k for k in got for u in IMAGE_UNITS)
    assert has_image == fusion
    assert any(k.endswith('num_batches_tracked') for k in got)
    # the state_dict exports as the model does
    sd_export = export_reference_state(model.state_dict())
    assert list(sd_export) == list(got)


def test_export_round_trips_into_the_port(built):
    _, _, model = built
    back = reference_state_to_state_dict(export_reference_state(model))
    own = model.state_dict()
    assert set(back) == set(own)
    for k, v in own.items():
        assert torch.equal(back[k], v), k


def _assert_tree_equal(got, want, path=''):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k], f'{path}/{k}')
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]),
                                          err_msg=f'{path}/{k}')


@pytest.mark.parametrize('writer', [False, True], ids=['sync', 'async'])
def test_cli_pth_converts_back_to_the_jax_tree(built, tmp_path, writer):
    _, tree, model = built
    w = AsyncCheckpointWriter() if writer else None
    ckpt = save_checkpoint(checkpoint_state(model, epoch=4, it=17),
                           str(tmp_path / 'ckpt' / 'checkpoint_epoch_4'),
                           writer=w)
    if w is not None:
        w.close()
    out = str(tmp_path / 'exported.pth')
    assert export_torch_weights.main(['--ckpt', ckpt[:-len('.pth')],
                                      '--out', out]) == out
    saved = torch.load(out, map_location='cpu', weights_only=True)
    assert saved['epoch'] == 4 and saved['it'] == 17
    assert saved['optimizer_state'] is None
    conv = convert_torch_checkpoint(saved)
    assert (conv['epoch'], conv['it']) == (4, 17)
    _assert_tree_equal(conv['model_state'], tree)
