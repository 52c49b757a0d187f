"""The premise of K7's own list of visibility walks a thread (``csrc/restir_gi.cu``).

K7 (ReSTIR GI's second stage, ``mono=False``) merges each shading pixel's
reservoir with N frame-shared neighbours and walks the reconnection
segment of every neighbour that counts and has p-hat > 0 (the JAX ``k2b``
at fypraytracer_tpu/render/megakernel_restir_gi.py:544-661).  Walked in
rounds, round k walks neighbour k for the lanes that need it while the rest
of the warp waits; walked from each thread's own list (the neighbours it
needs, in k order, one walk site), a warp walks as many times as its
longest list.  The walks and their answers are the same either way.

Here two frames of the plain ``mono=False`` loop run, then frame 3's K6
stage and K7 in its plain version (``restir_gi_k2_plain``) with each
neighbour's walks recorded (``_visible_where``: the segments and the mask
``ok & p_n > 0``).  The test builds each pixel's list from the masks,
shows that the (pixel, k) walks of the lists are the per-k walks, walks
the lists in list order through the wide segment test
(``segment_visible_wide``, the kernel's walk) and finds the per-k
answers, and counts, for warps of 32 consecutive pixels, the rounds (the
neighbours some lane walks) against the longest list.  Cornell and a
stress scene cut to tier-1's size, at 64², where the neighbours count.
"""

import pytest
import torch

from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.ops.traverse import segment_visible_wide
from fypraytracer_tpu_torch.render import megakernel_restir_gi as mg
from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene
from fypraytracer_tpu_torch.scene import procedural as tproc

SIZE = 64
WARP = 32
SETTINGS = RenderSettings(technique=SamplingTechnique.RESTIR_GI, bounces=2, samples=1,
                          sky_color=(0.05, 0.06, 0.08))


def _scene(name):
    if name == "stress":
        builder, cam = tproc.stress(SIZE, SIZE, grid=2, sphere_res=(6, 8))
    else:
        builder, cam = tproc.cornell_box(SIZE, SIZE)
    return morton_permuted_scene(builder.compile(native=True))[0].to("cpu"), cam


@pytest.mark.parametrize("name", ["cornell", "stress"])
def test_own_lists_walk_the_per_neighbour_walks(name, monkeypatch):
    scene, cam = _scene(name)
    B = SIZE * SIZE
    z = (torch.zeros((mg.GT_ROWS, B)), torch.zeros((mg.GS_ROWS, B)))
    _, state, _ = mg.restir_gi_megakernel_plain(scene, cam, *z, 1, 2, SETTINGS, cam.proj_view, cam.proj_view,
                                                mono=False)
    stage = mg.restir_gi_k1_plain(scene, cam, 3, SETTINGS, state, cam.proj_view)

    rounds = []
    visible_where = mg._visible_where

    def recorded(scn, o, d, dist, mask):
        vis = visible_where(scn, o, d, dist, mask)
        rounds.append(dict(o=o, d=d, dist=dist, mask=mask.clone(), vis=vis))
        return vis

    monkeypatch.setattr(mg, "_visible_where", recorded)
    mg.restir_gi_k2_plain(scene, cam, 3, SETTINGS, stage, state.clone(), torch.zeros((B, 3)))
    N = SETTINGS.spatial_neighbors
    assert len(rounds) == N
    masks = torch.stack([r["mask"] for r in rounds])              # (N, B): pixel walks neighbour k
    assert int(masks.sum()) > B // 32, int(masks.sum())

    # each pixel's list: the set bits of its mask, in k order (__ffs)
    bits = (masks.T.long() << torch.arange(N)).sum(1)             # (B,) the pass-A bitmask
    lists = [[k for k in range(N) if (int(b) >> k) & 1] for b in bits]
    per_list = {(p, k) for p, ks in enumerate(lists) for k in ks}
    per_k = {(int(p), k) for k in range(N) for p in masks[k].nonzero()[:, 0]}
    assert per_list == per_k

    # pass B: the lists walked in list order give each segment's answer
    longest = max(len(ks) for ks in lists)
    blocked = torch.zeros((N, B), dtype=torch.bool)
    for j in range(longest):
        pix = torch.tensor([p for p, ks in enumerate(lists) if len(ks) > j], dtype=torch.long)
        k = torch.tensor([lists[p][j] for p in pix.tolist()], dtype=torch.long)
        o = torch.stack([rounds[kk]["o"][p] for kk, p in zip(k.tolist(), pix.tolist())])
        d = torch.stack([rounds[kk]["d"][p] for kk, p in zip(k.tolist(), pix.tolist())])
        dist = torch.stack([rounds[kk]["dist"][p] for kk, p in zip(k.tolist(), pix.tolist())])
        blocked[k, pix] = ~segment_visible_wide(scene.wide, o, d, dist)
    for k in range(N):
        assert torch.equal(~blocked[k][masks[k]], rounds[k]["vis"][masks[k]]), k
    assert int(blocked.sum()) > 0                                 # some segments are blocked

    # warps of 32 consecutive pixels: rounds (neighbours some lane walks)
    # against the longest list a lane
    warp_masks = masks.reshape(N, B // WARP, WARP)
    warp_rounds = warp_masks.any(2).sum(0)                        # (warps,)
    warp_longest = warp_masks.sum(0).max(1).values
    assert bool((warp_rounds >= warp_longest).all())
    walks, n_rounds, n_longest = int(masks.sum()), int(warp_rounds.sum()), int(warp_longest.sum())
    print(f"{name} {SIZE}x{SIZE}, {N} neighbours: {walks} walks ({int(blocked.sum())} blocked); per warp "
          f"{n_rounds} rounds against {n_longest} in the longest lists ({n_rounds / max(n_longest, 1):.3f}x); "
          f"{walks / max(n_rounds, 1):.2f} walking lanes of {WARP} a round")
