"""``correct`` at test scale on the CPU: a sound run passes, the control
(the reference one precision step below in the program's place) fails, and
each fault the cells can have, planted in the program underneath the timed
path, fails. On the card (marked ``cuda``): a cell at its own size."""
import dataclasses

import pytest
import torch

from portbench.run import run_cell
from portbench.tests.tiny_cell import tiny

PE = "sam2_hiera_l-pe_core_l14"
CROP = "sam2_hiera_l-siglip_so400m_384"
CPU = torch.device("cpu")
SEED = 3 * 2 ** 31 + 5
# the bf16 mask source against the float32 reference at test scale: sound
# runs read 0.0075-0.0093, the float8 control 0.20-0.28 (seeds 1-3)
BF16_MASK_LIMIT = 0.05


def _run(config, batch, control=False, sam_dtype="float32", every=False,
         limits=None, without=()):
    bench, cfg, traffic, lim = tiny(config, batch, sam_dtype)
    if every:
        traffic["samples"] = 10 ** 6      # judge every keyframe
    lim.update(limits or {})
    for k in without:
        del lim[k]
    return run_cell(bench, "tiny", cfg, traffic, lim, SEED, 0.5, False, CPU,
                    control=control, log=lambda s: None)


def _failed(result):
    return sorted(k for k, v in result["checks"].items()
                  if v["value"] > v["limit"])


@pytest.mark.parametrize("config,batch", [(PE, 2), (CROP, 1)])
def test_sound_run_is_correct(config, batch):
    r = _run(config, batch)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


def test_control_fails():
    # at test scale's 16 prompts a bf16 mask source drops a near-tied mask
    # now and then (shortfall 0-0.043 over seeds 11-15): the count is left
    # to the float32 tests
    r = _run(PE, 2, control=True, sam_dtype="bfloat16",
             limits={"mask_logit_gap": BF16_MASK_LIMIT},
             without=("mask_shortfall",))
    assert r["correct"], r["checks"]
    # the harness's own verdict on the control, by the same limits
    assert r["control_correct"] is False, r["control_checks"]
    assert "mask_logit_gap" in _failed({"checks": r["control_checks"]})


def _clone(obj):
    return type(obj)(**{f.name: getattr(obj, f.name).clone()
                        for f in dataclasses.fields(obj)})


def test_fault_state_unchanged(monkeypatch):
    from ovo_tpu_torch.mapping import semantic

    real = semantic.associate_keyframe

    def stale(map_state, store, *args, **kw):
        before = _clone(map_state), _clone(store)
        _, _, match = real(map_state, store, *args, **kw)
        return before[0], before[1], match

    monkeypatch.setattr(semantic, "associate_keyframe", stale)
    assert "assoc_mismatch" in _failed(_run(PE, 2, every=True))


def test_fault_insert_unchanged(monkeypatch):
    from ovo_tpu_torch.slam import vanilla

    monkeypatch.setattr(vanilla, "map_insert_frame",
                        lambda state, *a, **k: state)
    assert "insert_mismatch" in _failed(_run(PE, 2))


def test_fault_half_batch_left_out(monkeypatch):
    from ovo_tpu_torch.models.sam.amg import AutomaticMaskSource

    real = AutomaticMaskSource.get_masks_batch

    def half(self, images, frame_ids=None):
        h = (len(images) + 1) // 2
        seg, bmaps, valid = real(self, images[:h], frame_ids[:h])
        pad = len(images) - h
        return (torch.cat([seg, seg[:pad]]), torch.cat([bmaps, bmaps[:pad]]),
                torch.cat([valid, valid[:pad]]))

    monkeypatch.setattr(AutomaticMaskSource, "get_masks_batch", half)
    assert "mask_logit_gap" in _failed(_run(PE, 2, every=True))


def test_fault_masks_left_out(monkeypatch):
    """The mask source keeps only each keyframe's first valid mask, and
    draws its seg map from what it kept: every mask it returns is one the
    reference has too, and only the comparison the other way finds the
    ones left out."""
    from ovo_tpu_torch.models.sam.amg import AutomaticMaskSource

    from portbench.calibrate import first_mask_only

    real = AutomaticMaskSource.get_masks_batch

    def first(self, images, frame_ids=None):
        seg, bmaps, valid = real(self, images, frame_ids)
        kept = [first_mask_only(bmaps[j], valid[j]) for j in range(len(valid))]
        return (torch.stack([k[0] for k in kept]).to(seg.dtype), bmaps,
                torch.stack([k[1] for k in kept]))

    monkeypatch.setattr(AutomaticMaskSource, "get_masks_batch", first)
    r = _run(PE, 2, every=True)
    failed = _failed(r)
    assert failed == ["mask_shortfall"], r["checks"]


def test_fault_first_inserts_dropped(monkeypatch):
    """The map drops the frames inserted before the first association: the
    window's stages, checked from the program's own state, cannot see it;
    the start, from the reference's own state, does."""
    from ovo_tpu_torch.slam import vanilla

    real = vanilla.map_insert_frame
    calls = []

    def dropped(state, *a, **k):
        calls.append(1)
        return state if len(calls) <= 2 else real(state, *a, **k)

    monkeypatch.setattr(vanilla, "map_insert_frame", dropped)
    assert "assoc_mismatch" in _failed(_run(PE, 2))


def test_fault_fused_masks_altered(monkeypatch):
    from ovo_tpu_torch.mapping import semantic

    real = semantic.associate_keyframe

    def altered(*args, **kw):
        state, store, match = real(*args, **kw)
        fused = match.fused_maps.clone()
        fused[:, :, : fused.shape[2] // 3] = False
        return state, store, dataclasses.replace(match, fused_maps=fused)

    monkeypatch.setattr(semantic, "associate_keyframe", altered)
    assert "assoc_mismatch" in _failed(_run(PE, 2, every=True))


def test_fault_mask_altered(monkeypatch):
    from ovo_tpu_torch.models.sam.amg import AutomaticMaskSource

    real = AutomaticMaskSource.get_masks

    def altered(self, image, frame_id=None):
        seg, bmaps, valid = real(self, image, frame_id)
        bmaps = bmaps.clone()
        bmaps[:, : bmaps.shape[1] // 4] ^= True
        return seg, bmaps, valid

    monkeypatch.setattr(AutomaticMaskSource, "get_masks", altered)
    assert {"mask_logit_gap", "seg_mismatch"} & set(_failed(_run(CROP, 1)))


@pytest.mark.parametrize("config,batch,method", [
    (PE, 2, "embed_masks_batch"), (CROP, 1, "embed_masks")])
def test_fault_descriptor_altered(monkeypatch, config, batch, method):
    from ovo_tpu_torch.models.clip import CropCLIPEmbedder
    from ovo_tpu_torch.models.textregion import TextRegionEmbedder

    cls = TextRegionEmbedder if config == PE else CropCLIPEmbedder
    real = getattr(cls, method)

    def altered(self, *args):
        out = real(self, *args).clone()
        out[..., :4] = -out[..., :4]
        return out

    monkeypatch.setattr(cls, method, altered)
    assert "desc_cos_gap" in _failed(_run(config, batch, every=True))


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.spec import load_cell

    bench, cell, cfg, traffic, limits = load_cell("replica.sam2_pe.b8")
    r = run_cell(bench, cell["name"], cfg, traffic, limits, SEED, 3.0, False,
                 torch.device("cuda", 0), log=lambda s: None)
    assert r["correct"], r["checks"]
