"""Houdini integration shim — the SOP surface as Python-SOP cook functions
(counterpart of `vqvdb_tpu/integrations/houdini.py`; the codec runs on
`cuda` unless a cook is given `device="cpu"`).

The reference ships compiled HDK SOP nodes (src/SOP/SOP_VQVDB_Encoder.cpp,
SOP_VQVDB_Decoder.cpp) with parameters vdbname / outputpath / inputfile /
batchsize / execute. Houdini's Python SOP runs this module directly: drop
a Python SOP, `import vqvdb_tpu_torch.integrations.houdini as vq`, and call
`cook_encoder` / `cook_decoder` from the node's code with the same
parameter names.

In-Houdini data exchange uses two bridges, most robust first:

  1. Geometry-file bridge (primary): `hou.Geometry.saveToFile` writes the
     input VDB prims to a temp .vdb, which the port's own spec-derived
     OpenVDB reader (vdb/openvdb_io.py) ingests exactly (leaves, masks, transforms — no dense
     materialization). The decoder inverts it: our writer emits a temp
     .vdb and `hou.Geometry.loadFromFile` pulls real sparse VDB prims back
     into the node. Mirrors the reference's loadGrid /
     GU_PrimVDB::buildFromGrid endpoints (SOP_VQVDB_Encoder.cpp:115-129,
     SOP_VQVDB_Decoder.cpp:109-114).
  2. Voxel-sampling fallback: if the file bridge fails for a reason the
     reader can't handle (an exotic tree configuration, a future format
     revision), VDB prims are read through
     `hou.VDB.activeVoxelBoundingBox()` + `voxelRangeAsFloat()` (dense
     over the active bbox, then sparsified), and `hou.Volume` prims
     through `resolution()` + `allVoxels()`. Houdini's default save
     settings (blosc compression, 16-bit floats) are handled natively by
     the primary bridge (vdb/blosc.py, half-float framing in
     vdb/openvdb_io.py), so the fallback is a safety net, not the
     production path.

Both cooks degrade gracefully outside Houdini (node=None): they accept /
return LeafGrids, so the module doubles as the reference's verb layer for
any DCC that embeds Python. Both in-Houdini paths are unit-tested against
a fake `hou` module (tests/fake_hou.py, in
tests/test_torch_port_houdini.py) that emulates the documented API
surface.
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from vqvdb_tpu_torch import api
from vqvdb_tpu_torch.core.weights import DeviceLike
from vqvdb_tpu_torch.vdb.grid import LeafGrid


# ---------------------------------------------------------------------------
# Houdini -> LeafGrid
# ---------------------------------------------------------------------------

def _prim_name(prim, default: str = "density") -> str:
    # The grid name lives in the 'name' primitive attribute; on real
    # hou.Prim the attribute is looked up via the owning geometry
    # (Geometry.findPrimAttrib) — there is no prim.findAttrib.
    try:
        geo = prim.geometry()
        if geo is not None and geo.findPrimAttrib("name") is not None:
            return prim.attribValue("name") or default
    except Exception:
        pass
    try:
        return prim.attribValue("name") or default
    except Exception:
        return default


def _grids_via_geo_file(geo) -> List[LeafGrid]:
    """Primary bridge: round the geometry through a temp .vdb file."""
    from vqvdb_tpu_torch.vdb.openvdb_io import read_vdb_leafgrids

    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "vqvdb_bridge.vdb"
        geo.saveToFile(str(path))
        return read_vdb_leafgrids(path)


def _dense_from_vdb_prim(prim, hou) -> Optional[LeafGrid]:
    """Fallback: sample a hou.VDB prim densely over its active bbox.

    hou.VDB.voxelRangeAsFloat returns values with the x index changing
    fastest (Houdini volume voxel ordering), hence the Fortran-order
    reshape.
    """
    bbox = prim.activeVoxelBoundingBox()
    lo = np.asarray(bbox.minvec(), np.int64)
    hi = np.asarray(bbox.maxvec(), np.int64)
    res = (hi - lo + 1).astype(int)
    if np.any(res <= 0):
        return None
    # Dense sampling materializes the whole active bbox; a sparse grid
    # spanning a large index box would allocate res^3 floats. Refuse
    # beyond ~512 MB rather than taking down the Houdini session.
    if int(np.prod(res)) > 512 ** 3:
        raise ValueError(
            f"VDB prim '{_prim_name(prim)}' active bbox {tuple(res)} is too "
            "large to sample densely — and the sparse file bridge already "
            "failed; report its error, that path handles large grids")
    name = _prim_name(prim)
    if hasattr(prim, "voxelRangeAsVector3") and _is_vector_vdb(prim):
        flat = np.asarray(prim.voxelRangeAsVector3(bbox), np.float32)
        dense = flat.reshape((*res[::-1], 3)).transpose(2, 1, 0, 3)
    else:
        flat = np.asarray(prim.voxelRangeAsFloat(bbox), np.float32)
        dense = flat.reshape(res[::-1]).transpose(2, 1, 0)
    # Align leaves with the VDB's own index space so origins round-trip.
    origin = (lo // 8) * 8
    pad_lo = (lo - origin).astype(int)
    if np.any(pad_lo):
        pads = [(int(p), 0) for p in pad_lo]
        if dense.ndim == 4:
            pads.append((0, 0))
        dense = np.pad(dense, pads)
    return LeafGrid.from_dense(name, dense, origin=tuple(int(v) for v in origin))


def _is_vector_vdb(prim) -> bool:
    try:
        return "vec" in str(prim.dataType()).lower()
    except Exception:
        return False


def _dense_from_volume_prim(prim) -> LeafGrid:
    """hou.Volume prims: resolution() + allVoxels() (x fastest)."""
    res = tuple(int(v) for v in prim.resolution())
    flat = np.asarray(prim.allVoxels(), np.float32)
    dense = flat.reshape(res[::-1]).transpose(2, 1, 0)
    return LeafGrid.from_dense(_prim_name(prim), dense)


def _grids_from_hou_node(node) -> List[LeafGrid]:
    """Extract VDB/Volume prims from a Houdini node's first input."""
    import hou  # available only inside Houdini

    inputs = node.inputs()
    if not inputs or inputs[0] is None:
        raise ValueError("encoder node has no connected input")
    geo = inputs[0].geometry()

    try:
        grids = _grids_via_geo_file(geo)
        if grids:
            return grids
    except Exception as e:
        # Unhandled tree/format configuration; fall through to direct
        # sampling — but say so instead of hiding reader bugs.
        import sys

        print(f"vqvdb: sparse .vdb bridge failed ({type(e).__name__}: {e}); "
              "falling back to dense prim sampling", file=sys.stderr)

    grids = []
    for prim in geo.prims():
        ptype = prim.type()
        if ptype == hou.primType.VDB:
            g = _dense_from_vdb_prim(prim, hou)
            if g is not None:
                grids.append(g)
        elif ptype == hou.primType.Volume:
            grids.append(_dense_from_volume_prim(prim))
    return grids


# ---------------------------------------------------------------------------
# Cooks (ref: SOP_VQVDB_EncoderVerb::cook / SOP_VQVDB_DecoderVerb::cook)
# ---------------------------------------------------------------------------

def cook_encoder(
    *,
    outputpath: str,
    vdbname: str = "",
    batchsize: int = 4096,
    model: str = "",
    node=None,
    grids: Optional[Sequence[LeafGrid]] = None,
    residual: Optional[str] = None,
    device: DeviceLike = None,
) -> dict:
    """Encoder cook (ref: SOP_VQVDB_Encoder.cpp:84-141 — collect grids,
    filter by name, compress to outputpath). `residual` ('int8'/'f16')
    selects the v6 near-lossless tier — a parm the HDK node could not
    offer (the reference container is index-only). `device`: where the
    codec runs (default `cuda`)."""
    if grids is None:
        if node is None:
            raise ValueError("pass `grids` outside Houdini, or `node` inside")
        grids = _grids_from_hou_node(node)
    return api.encode(list(grids), model, outputpath,
                      batch_size=batchsize,
                      name_filter=vdbname or None,
                      residual=residual, device=device)


def cook_decoder(
    *,
    inputfile: str,
    batchsize: int = 4096,
    model: str = "",
    vdbname: str = "",
    node=None,
    device: DeviceLike = None,
) -> List[LeafGrid]:
    """Decoder cook (ref: SOP_VQVDB_Decoder.cpp:78-115 — generator node:
    read file, decode, build grids). Inside Houdini the decoded grids are
    written to a temp .vdb by our own writer and merged onto the node's
    geometry with hou.Geometry.loadFromFile, which builds real sparse VDB
    prims (the GU_PrimVDB::buildFromGrid equivalent). `vdbname` selects one
    grid — unlike the reference (which decodes everything and filters
    nothing, SOP_VQVDB_Decoder.cpp), unselected payloads are skipped on
    disk. `device`: where the codec runs (default `cuda`). Always returns
    the LeafGrids."""
    grids, _ = api.decode(inputfile, model, batch_size=batchsize,
                          grids=vdbname or None, device=device)
    if node is not None:
        from vqvdb_tpu_torch.vdb.openvdb_io import write_vdb_leafgrids

        with tempfile.TemporaryDirectory() as td:
            path = Path(td) / "vqvdb_decoded.vdb"
            write_vdb_leafgrids(path, grids)
            node.geometry().loadFromFile(str(path))
    return grids
