"""One process: the port's (data, points) mesh with nothing split.

The reference runs every model in one process on the whole batch and the
whole cloud, so each query of the mesh answers "not split" and each
exchange is the identity."""

from __future__ import annotations

import contextlib


def split():
    return None


def points_split():
    return None


def global_rows(n: int) -> int:
    return n


def local_rows(t):
    return t


def gather_points(x, dim: int = 1, replicated: bool = False):
    return x


def scatter_points(x, dim: int = 1):
    return x


def halo(x, dim: int, left: int, right: int):
    raise RuntimeError('halo: the reference never splits the image width')


def loss_sum(x):
    return x


def stat_sum(x):
    return x


@contextlib.contextmanager
def rank_local():
    yield


@contextlib.contextmanager
def points_region():
    yield


def batch_max(x):
    return x


def sum_grads(params, replicated=()):
    return None
