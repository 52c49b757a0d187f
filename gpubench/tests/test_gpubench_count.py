"""The frozen operation and byte counts in each cell's file are what the
counting script gives (the CPU; the stress scene's SAH build takes a while
on a checkout's first run, then comes from .gpubench_cache)."""

import json

import pytest

from gpubench.control import bench_with_held_out
from gpubench.count import count
from gpubench.run import Cell


@pytest.mark.parametrize("name", [w["name"] for w in bench_with_held_out()["workloads"]])
def test_counts_are_reproduced(name):
    cell = Cell.find(name, bench_with_held_out())
    assert json.loads(json.dumps(count.count_cell(cell))) == cell.data["frozen"]


def test_rays_per_frame_is_the_published_formula():
    # primary + bounce + shadow rays a path (NEE: one shadow ray a bounce)
    assert count.rays_per_frame(1920, 1088, 1, 2, shadow_rays_per_bounce=1) == 1920 * 1088 * 5
    assert count.rays_per_frame(4, 4, 2, 3) == 4 * 4 * 2 * 4
    assert count.rays_per_frame(4, 4, 1, 2, visibility_rays=5) == 4 * 4 * 8
