"""The premise of K3's p-hat once per emitter (``csrc/restir_di.cu``).

K3 (ReSTIR DI's first stage) draws M = 8 candidates uniformly over the
emissive list and weighs each by p-hat at its emitter's centroid, then
weighs the previous reservoir's emitter by p-hat once more for temporal
reuse (the JAX ``k1`` at fypraytracer_tpu/render/megakernel_restir.py:
219-240, 313-325, 327-399).  p-hat depends on the pixel's surface and the
emitter only, so a pixel's 9 evaluations take at most ``ne`` distinct
inputs: where the list is short the kernel can evaluate each emitter once
and read every candidate's value from that table, bit for bit.

Here two frames of the plain DI loop run, then frame 3's K3 in its plain
version (``restir_di_k3_plain``) with its p-hat evaluations recorded: the
test counts the distinct emitters among each shading pixel's 9, and
replaces every evaluation by a gather from a table of all the emitters'
values (zero where the pixel does not shade, as the kernel skips them
there), which must leave the stage unchanged, bit for bit.  Cornell and a
stress scene cut to tier-1's size (2 emitters each, within the kernel's
table), and Cornell with the rough sphere's material made emissive
through ``SceneManager.set_material`` (578 emitters, far more than the 9
evaluations: the kernel keeps a p-hat a candidate there).
"""

import pytest
import torch

from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu_torch.render import megakernel_restir as mr
from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene
from fypraytracer_tpu_torch.scene import procedural as tproc
from fypraytracer_tpu_torch.scene.manager import SceneManager

SIZE = 32
K_PHAT_TABLE = 4       # csrc/restir_di.cu::kPhatTable
SETTINGS = RenderSettings(technique=SamplingTechnique.RESTIR_DI, bounces=2, samples=1,
                          sky_color=(0.05, 0.06, 0.08))


def _scene(name):
    if name == "stress":
        builder, cam = tproc.stress(SIZE, SIZE, grid=2, sphere_res=(6, 8))
    else:
        builder, cam = tproc.cornell_box(SIZE, SIZE)
        if name == "cornell_many_emitters":
            SceneManager(builder).set_material(4, emission_color=(1.0, 0.8, 0.6), emission_power=3.0)
    return morton_permuted_scene(builder.compile(native=True))[0].to("cpu"), cam


@pytest.mark.parametrize("name", ["cornell", "stress", "cornell_many_emitters"])
def test_phat_table_gives_the_stage_bit_for_bit(name, monkeypatch):
    scene, cam = _scene(name)
    em = mr.prepare_emissive_table(scene)
    state = torch.zeros((mr.ST_ROWS, SIZE * SIZE))
    mr.restir_di_megakernel_plain(scene, em, cam, state, 1, 2, SETTINGS, cam.proj_view, cam.proj_view)

    calls = []
    p_hat = mr._p_hat

    def recorded(table, e, *surface):
        calls.append(e.clone())
        return p_hat(table, e, *surface)

    monkeypatch.setattr(mr, "_p_hat", recorded)
    stage = mr.restir_di_k3_plain(scene, em, cam, 3, SETTINGS, state, cam.proj_view)
    assert len(calls) == SETTINGS.light_candidates + 1
    shade = stage[mr.S_SHADE] > 0.5
    assert int(shade.sum()) > SIZE * SIZE // 4
    emitters = torch.stack(calls)[:, shade]                     # (9, shading pixels)
    distinct = torch.tensor([len(set(col.tolist())) for col in emitters.T])
    assert int(distinct.max()) <= min(em.n, len(calls))
    if em.n <= K_PHAT_TABLE:
        assert int(emitters.max()) < em.n                       # every evaluation is in the table
    else:
        assert em.n > 4 * len(calls) and float(distinct.float().mean()) > len(calls) - 1

    def from_table(table, e, pos, n, view, alb, rough, metal):
        every = torch.stack([p_hat(table, torch.full_like(e, j), pos, n, view, alb, rough, metal)
                             for j in range(table.n)], 1)        # (B, ne)
        got = every.gather(1, e[:, None])[:, 0]
        assert torch.equal(got, p_hat(table, e, pos, n, view, alb, rough, metal))
        return torch.where(shade, got, 0.0)

    monkeypatch.setattr(mr, "_p_hat", from_table)
    assert torch.equal(mr.restir_di_k3_plain(scene, em, cam, 3, SETTINGS, state, cam.proj_view), stage)
    print(f"{name}: {em.n} emitters; {int(shade.sum())} shading pixels; distinct emitters of their "
          f"{len(calls)} p-hat evaluations: mean {float(distinct.float().mean()):.3f}, max {int(distinct.max())}")
