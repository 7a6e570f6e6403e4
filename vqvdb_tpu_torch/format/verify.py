"""Container integrity and round-trip fidelity audit (counterpart of
`vqvdb_tpu/format/verify.py`).

1. ``verify_container(path)``: a structural audit without a model. It walks
   every grid and every batch (residual streams included) and checks what
   the format implies but the reader does not enforce: leaf origins on the
   8^3 lattice, no duplicate origins, indices < num_embeddings, finite
   transforms, finite positive residual scales, finite f16 residuals.
   Reader failures (bad magic, truncation, inconsistent counts) are
   reported, not raised.

2. ``verify_roundtrip(path, codec, sources)``: decode the file with the
   port's `VQCodec` and compare with the source grids leaf by leaf (matched
   by origin): PSNR / MSE / max abs error per grid and coverage. For v6 int8
   grids it also checks the tier's bound, max error <= max(scale) / 2,
   which holds when the decode repeats the encode's decode step (the same
   codec configuration, so the same batch size and compute dtype).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from vqvdb_tpu_torch.core.config import LEAF_DIM
from vqvdb_tpu_torch.format.vqvdb import (
    RESIDUAL_MODE_NAMES,
    VqvdbReader,
)
from vqvdb_tpu_torch.utils.errors import FormatError, VersionError

PathLike = Union[str, Path]

_BATCH = 8192


def _check_grid_payload(reader: VqvdbReader, meta) -> Dict:
    """Read one grid's full payload, accumulating structural issues."""
    issues: List[str] = []
    seen = set()
    leaves_read = 0
    max_index = -1
    dup = misaligned = 0
    bad_scales = bad_residuals = 0
    max_scale = 0.0
    while reader.has_next():
        indices, origins, scales, residual = reader.next_batch_residual(_BATCH)
        leaves_read += origins.shape[0]
        if origins.size:
            if np.any(origins % LEAF_DIM != 0):
                misaligned += int(np.count_nonzero(
                    np.any(origins % LEAF_DIM != 0, axis=1)))
            for key in map(bytes, np.ascontiguousarray(origins)):
                if key in seen:
                    dup += 1
                else:
                    seen.add(key)
        if indices.size:
            max_index = max(max_index, int(indices.max()))
        if scales is not None and scales.size:
            ok = np.isfinite(scales) & (scales > 0)
            bad_scales += int(np.count_nonzero(~ok))
            max_scale = max(max_scale, float(scales.max()))
        if residual is not None and residual.size \
                and residual.dtype == np.float16:
            bad_residuals += int(np.count_nonzero(
                ~np.isfinite(residual.astype(np.float32))))
    if misaligned:
        issues.append(f"{misaligned} leaf origin(s) off the {LEAF_DIM}^3 "
                      "lattice")
    if dup:
        issues.append(f"{dup} duplicate leaf origin(s)")
    if max_index >= meta.num_embeddings:
        issues.append(f"index {max_index} >= num_embeddings "
                      f"{meta.num_embeddings}")
    if leaves_read != meta.total_blocks:
        issues.append(f"read {leaves_read} leaves, metadata declares "
                      f"{meta.total_blocks}")
    if not np.all(np.isfinite(meta.transform)):
        issues.append("non-finite transform")
    if bad_scales:
        issues.append(f"{bad_scales} non-finite/non-positive residual "
                      "scale(s)")
    if bad_residuals:
        issues.append(f"{bad_residuals} non-finite f16 residual value(s)")
    return {
        "name": meta.name,
        "leaves": leaves_read,
        "declared_leaves": meta.total_blocks,
        "latent_shape": list(meta.latent_shape),
        "residual": RESIDUAL_MODE_NAMES[meta.residual_mode],
        "codec": reader.grid_codec,
        "max_index": max_index,
        "residual_bound": (max_scale / 2.0) if meta.residual_mode == 1
        else None,
        "issues": issues,
    }


def verify_container(path: PathLike) -> Dict:
    """Structural audit of a `.vqvdb` file. Never raises on bad content —
    returns ``{"ok": False, "error": ...}`` with whatever was readable."""
    grids: List[Dict] = []
    error: Optional[str] = None
    version = num_grids = None
    try:
        with VqvdbReader(path) as reader:
            version, num_grids = reader.version, reader.num_grids
            while reader.has_next_grid():
                meta = reader.next_grid_metadata()
                grids.append(_check_grid_payload(reader, meta))
    except (FormatError, VersionError, OSError) as e:
        error = f"{type(e).__name__}: {e}"
    ok = error is None and all(not g["issues"] for g in grids)
    out = {"ok": ok, "path": str(path), "version": version,
           "num_grids": num_grids, "grids": grids}
    if error:
        out["error"] = error
    return out


def _match_by_origin(src_origins: np.ndarray, dec_origins: np.ndarray):
    """Row indices (src_idx, dec_idx) of origins present in both, plus
    counts of rows only in one side."""
    src_keys = {bytes(r): i
                for i, r in enumerate(np.ascontiguousarray(src_origins))}
    src_idx, dec_idx = [], []
    extra = 0
    for j, r in enumerate(np.ascontiguousarray(dec_origins)):
        i = src_keys.pop(bytes(r), None)
        if i is None:
            extra += 1
        else:
            src_idx.append(i)
            dec_idx.append(j)
    return (np.asarray(src_idx, np.int64), np.asarray(dec_idx, np.int64),
            len(src_keys), extra)


def verify_roundtrip(
    path: PathLike,
    codec,
    sources: Sequence,
    *,
    bound_slack: float = 1e-4,
) -> Dict:
    """Decode `path` with `codec` and compare against source LeafGrids.

    Matching is by grid name, then leaf origin. For v6 int8 grids the
    measured max error is checked against the stored-scale bound (see
    module docstring for the same-codec-config caveat)."""
    container = verify_container(path)
    if container.get("error"):
        # The archive didn't even read structurally — decoding it would
        # re-raise the same reader failure as a stack trace, which is the
        # one thing an audit tool must not do. Report the diagnosis.
        return {"ok": False, "integrity": container, "grids": []}
    try:
        grids, _ = codec.decompress(path)
    except (FormatError, VersionError, OSError) as e:
        container = dict(container)
        container["ok"] = False
        container["error"] = f"{type(e).__name__}: {e}"
        return {"ok": False, "integrity": container, "grids": []}
    by_name = {g.name: g for g in sources}
    bounds = {g["name"]: g.get("residual_bound")
              for g in container.get("grids", [])}
    report: List[Dict] = []
    ok = container["ok"]
    for dec in grids:
        src = by_name.get(dec.name)
        row: Dict = {"name": dec.name, "decoded_leaves": dec.num_leaves}
        if src is None:
            row["issues"] = ["no source grid with this name"]
            ok = False
            report.append(row)
            continue
        si, di, missing, extra = _match_by_origin(src.origins, dec.origins)
        row["matched_leaves"] = int(si.size)
        row["source_only_leaves"] = missing
        row["file_only_leaves"] = extra
        issues: List[str] = []
        if extra:
            issues.append(f"{extra} decoded leaf origin(s) absent from the "
                          "source")
        if si.size:
            a = src.leaves[si].astype(np.float64)
            b = dec.leaves[di].astype(np.float64)
            err = np.abs(a - b)
            m = float(np.mean((a - b) ** 2))
            row["mse"] = m
            # A lossless match would be +inf dB, but `Infinity` is not
            # valid strict JSON (breaks jq and non-Python consumers of the
            # CLI's output). Emit null; consumers key off mse == 0.
            row["psnr_db"] = None if m == 0 else float(-10.0 * np.log10(m))
            row["max_abs_err"] = float(err.max())
            bound = bounds.get(dec.name)
            if bound is not None:
                row["residual_bound"] = bound
                row["bound_ok"] = bool(
                    row["max_abs_err"] <= bound * (1.0 + bound_slack) + 1e-9)
                if not row["bound_ok"]:
                    issues.append(
                        f"max error {row['max_abs_err']:.3e} exceeds the "
                        f"stored residual bound {bound:.3e}")
        row["issues"] = issues
        if issues:
            ok = False
        report.append(row)
    decoded_names = {g.name for g in grids}
    for name in by_name:
        if name not in decoded_names:
            report.append({"name": name,
                           "issues": ["source grid missing from the file"]})
            ok = False
    return {"ok": ok, "integrity": container, "grids": report}
