"""The frame-sequence traffic generator."""

import json
from pathlib import Path

import torch

from portbench import frames

BENCH = Path(__file__).resolve().parent.parent
SMALL = {"frames": 3, "first_leaves": 30, "step_leaves": 20, "domain": [64, 64, 48],
         "blobs": 6, "extra_blobs": 4, "sigma": [4.0, 10.0]}


def _traffic(**kw):
    t = json.loads((BENCH / "traffic" / "frames-encode.json").read_text())
    return {**t, **SMALL, **kw}


def test_frame_sizes_of_the_traffic_files():
    for mix in ("frames-decode", "frames-encode"):
        t = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
        sizes = frames.frame_sizes(t)
        assert sizes[0] == 16_000 and sizes[-1] == 57_250 and len(sizes) == 16
        assert sum(sizes) / len(sizes) == 36_625


def test_a_seed_gives_the_same_frames_and_another_seed_others():
    t = _traffic()
    a = frames.make_frames(t, 1, 2**31 + 3, torch.device("cpu"))
    b = frames.make_frames(t, 1, 2**31 + 3, torch.device("cpu"))
    c = frames.make_frames(t, 1, 5, torch.device("cpu"))
    assert all(torch.equal(x["leaves"], y["leaves"]) and torch.equal(x["origins"], y["origins"])
               for x, y in zip(a, b))
    assert not torch.equal(a[-1]["leaves"], c[-1]["leaves"])


def test_frames_have_their_sizes_in_range_and_on_leaf_origins():
    t = _traffic()
    for channels, lo in ((1, 0.0), (3, -1.0)):
        made = frames.make_frames(t, channels, 17, torch.device("cpu"))
        for frame, n in zip(made, frames.frame_sizes(t)):
            o, x = frame["origins"], frame["leaves"]
            assert o.shape == (n, 3) and x.shape == (n, 8, 8, 8, channels)
            assert (o % 8 == 0).all() and (o >= 0).all()
            assert (o < torch.tensor(t["domain"])).all()
            assert x.min() >= lo and x.max() <= 1.0
            peak = x.abs().amax(dim=-1)
            assert ((peak == 0) | (peak >= t["threshold"])).all()
            assert (peak.flatten(1).amax(dim=1) >= t["threshold"]).all()  # every leaf active
            assert len({tuple(r) for r in o.tolist()}) == n


def test_a_field_too_small_for_its_frame_gets_more_blobs():
    t = _traffic(blobs=1, extra_blobs=1, first_leaves=150, step_leaves=0, frames=1)
    (frame,) = frames.make_frames(t, 1, 3, torch.device("cpu"))
    assert frame["origins"].shape[0] == 150
