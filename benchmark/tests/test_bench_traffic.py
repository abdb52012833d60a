"""The traffic generators repeat for a seed, differ across seeds, give
every seed the same sizes, and take seeds beyond 32 bits."""

import numpy as np
import pytest

from harness import scenes
from tiny import tiny_cell

BIG = 2 ** 31 + 987654321


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", ["dtu-train", "bmvs-mesh"])
def test_scene_repeats_for_a_seed(name):
    cell = tiny_cell(name)
    p = cell.traffic["scene"]
    a = scenes.make_scene(p, 3, (64, 64), BIG, 2)
    _same(a, scenes.make_scene(p, 3, (64, 64), BIG, 2))
    b = scenes.make_scene(p, 3, (64, 64), BIG + 1, 2)
    assert not np.array_equal(a["imgs"], b["imgs"])
    assert a["imgs"].shape == b["imgs"].shape == (3, 64, 64, 3)
    assert np.isfinite(a["imgs"]).all() and (a["imgs"] > 0.05).any()


def test_train_batch_repeats_for_a_seed():
    cell = tiny_cell("dtu-train")
    scene = scenes.make_scene(cell.traffic["scene"], 5, (64, 64), BIG, 0)
    a = scenes.train_batch(scene, 64, 32, 16, BIG, 7)
    _same(a, scenes.train_batch(scene, 64, 32, 16, BIG, 7))
    b = scenes.train_batch(scene, 64, 32, 16, BIG, 8)
    assert not np.array_equal(a["rays_d"], b["rays_d"])
    assert a["rays_o"].shape == (64, 3) and a["pseudo_pts"].shape == (32, 3)
    assert a["perturb_noise"].min() >= -0.5 and a["perturb_noise"].max() < 0.5
    assert np.abs(a["sparse_pts"]).max() <= 1.0


def test_train_loop_batches_match_the_reference_feed():
    from harness.core import load_module
    import os
    from harness.core import BENCH_DIR

    loop = load_module(os.path.join(BENCH_DIR, "loops", "train.py"))
    cell = tiny_cell("dtu-train")
    pool = loop.make_pool(cell, BIG)
    assert len(pool) == cell.traffic["pool"]
    a = loop.batch(cell, pool, BIG, 5)
    _same(a, loop.batch(cell, loop.make_pool(cell, BIG), BIG, 5))
    np.testing.assert_array_equal(a["imgs"], pool[5 % len(pool)]["imgs"])


def test_grid_sample_repeats_for_a_seed():
    import os
    from harness.core import BENCH_DIR, load_module

    loop = load_module(os.path.join(BENCH_DIR, "loops", "mesh.py"))
    cell = tiny_cell("bmvs-mesh")
    a = loop.sample_indices(cell, BIG, 1)
    np.testing.assert_array_equal(a, loop.sample_indices(cell, BIG, 1))
    assert not np.array_equal(a, loop.sample_indices(cell, BIG, 2))
    assert a.max() < 32 ** 3 and len(a) == 4096
