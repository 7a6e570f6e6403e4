"""Procedural volume generation for training, testing and benchmarking
(counterpart of `vqvdb_tpu/train/synthetic.py`, the same numpy generators:
the same seed gives the same bits).

The reference assumes leaf datasets extracted from production VDBs
(README "extract leaves to .npy"); in a hermetic environment we need
volumes with comparable structure. These generators produce smoke/cloud-like
scalar fields (fBm value noise shaped by radial falloffs) and curl-ish vec3
fields, then sparsify them into LeafGrids / leaf arrays.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import List, Tuple

import numpy as np

from vqvdb_tpu_torch.vdb.grid import LeafGrid

# Seeds 1000..1999 are reserved for held-out evaluation pools (gen_eval_r3,
# data_scaling, retrain_scale all draw eval volumes from seed 1000 upward).
# Training pools must never draw from this band; use train_seeds() below.
EVAL_SEED_BAND = (1000, 2000)


def train_seeds(n: int, start: int = 0) -> List[int]:
    """First `n` seeds counting up from `start`, skipping the reserved
    eval band [1000, 2000). Keeps pools <=1000 volumes identical to the
    historical 0..n-1 scheme while making larger pools contamination-free."""
    lo, hi = EVAL_SEED_BAND
    out, s = [], start
    while len(out) < n:
        if not (lo <= s < hi):
            out.append(s)
        s += 1
    return out


# ---------------------------------------------------------------------------
# Volume cache
#
# Generation is pure CPU numpy and every training/eval harness regenerates
# its pools from scratch; a content cache keyed by (family, size, seed) in
# the temporary directory ($VQVDB_SYNTH_CACHE, or "off") makes reruns cheap. Generators are
# deterministic in (seed,) so cached bits == fresh bits; bump _CACHE_VERSION
# on ANY change to the generator math.
_CACHE_VERSION = 1


def _cache_dir() -> Path | None:
    env = os.environ.get("VQVDB_SYNTH_CACHE")
    if env == "0" or env == "off":
        return None
    if env:
        return Path(env)
    return Path(tempfile.gettempdir()) / f"vqvdb_synth_v{_CACHE_VERSION}"


def _cached_grid(family: str, size: int, seed: int, name: str, build) -> LeafGrid:
    d = _cache_dir()
    if d is None:
        return build()
    path = d / f"{family}_{size}_{seed}.npz"
    if path.exists():
        try:
            with np.load(path) as z:
                return LeafGrid(name=name, origins=z["origins"], leaves=z["leaves"])
        except Exception:
            path.unlink(missing_ok=True)
    g = build()
    try:
        d.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".tmp{os.getpid()}_{path.name}")
        with tmp.open("wb") as fh:
            np.savez(fh, origins=g.origins, leaves=g.leaves)
        os.replace(tmp, path)
    except OSError:
        pass  # cache is best-effort; never fail generation over it
    return g


def _value_noise_3d(shape: Tuple[int, int, int], cell: int, rng) -> np.ndarray:
    """Trilinearly-interpolated lattice noise in [0,1]."""
    gx = shape[0] // cell + 2
    gy = shape[1] // cell + 2
    gz = shape[2] // cell + 2
    lattice = rng.random((gx, gy, gz), dtype=np.float32)
    x = np.arange(shape[0], dtype=np.float32) / cell
    y = np.arange(shape[1], dtype=np.float32) / cell
    z = np.arange(shape[2], dtype=np.float32) / cell
    xi, yi, zi = x.astype(int), y.astype(int), z.astype(int)
    xf = (x - xi)[:, None, None]
    yf = (y - yi)[None, :, None]
    zf = (z - zi)[None, None, :]

    def s(t):  # smoothstep
        return t * t * (3.0 - 2.0 * t)

    xf, yf, zf = s(xf), s(yf), s(zf)
    c = lattice
    n000 = c[np.ix_(xi, yi, zi)]
    n100 = c[np.ix_(xi + 1, yi, zi)]
    n010 = c[np.ix_(xi, yi + 1, zi)]
    n110 = c[np.ix_(xi + 1, yi + 1, zi)]
    n001 = c[np.ix_(xi, yi, zi + 1)]
    n101 = c[np.ix_(xi + 1, yi, zi + 1)]
    n011 = c[np.ix_(xi, yi + 1, zi + 1)]
    n111 = c[np.ix_(xi + 1, yi + 1, zi + 1)]
    nx00 = n000 * (1 - xf) + n100 * xf
    nx10 = n010 * (1 - xf) + n110 * xf
    nx01 = n001 * (1 - xf) + n101 * xf
    nx11 = n011 * (1 - xf) + n111 * xf
    nxy0 = nx00 * (1 - yf) + nx10 * yf
    nxy1 = nx01 * (1 - yf) + nx11 * yf
    return nxy0 * (1 - zf) + nxy1 * zf


def fbm_noise(shape: Tuple[int, int, int], rng, octaves: int = 3,
              base_cell: int = 16) -> np.ndarray:
    """Fractal Brownian motion noise in [0,1]."""
    out = np.zeros(shape, np.float32)
    amp, total = 1.0, 0.0
    cell = base_cell
    for _ in range(octaves):
        out += amp * _value_noise_3d(shape, max(cell, 2), rng)
        total += amp
        amp *= 0.5
        cell //= 2
    return out / total


def smoke_volume(size: int = 64, seed: int = 0, n_puffs: int = 3) -> np.ndarray:
    """Cloud-like scalar density in [0,1], mostly sparse."""
    rng = np.random.default_rng(seed)
    shape = (size, size, size)
    noise = fbm_noise(shape, rng, octaves=3, base_cell=size // 4)
    coords = np.mgrid[0:size, 0:size, 0:size].astype(np.float32)
    density = np.zeros(shape, np.float32)
    for _ in range(n_puffs):
        center = rng.random(3) * size
        radius = size * (0.15 + 0.2 * rng.random())
        r = np.sqrt(((coords - center[:, None, None, None]) ** 2).sum(0))
        falloff = np.clip(1.0 - r / radius, 0.0, 1.0)
        density = np.maximum(density, falloff)
    out = np.clip(density * (0.4 + 0.9 * noise), 0.0, 1.0)
    out[out < 0.02] = 0.0  # sparsify
    return out


def velocity_volume(size: int = 64, seed: int = 0) -> np.ndarray:
    """Swirly vec3 field in [-1,1]^3, masked by a smoke density."""
    rng = np.random.default_rng(seed)
    mask = smoke_volume(size, seed=seed + 7) > 0
    comps = [2.0 * fbm_noise((size,) * 3, rng, octaves=2, base_cell=size // 2) - 1.0
             for _ in range(3)]
    vel = np.stack(comps, axis=-1).astype(np.float32)
    vel[~mask] = 0.0
    return np.clip(vel, -1.0, 1.0)


def levelset_volume(size: int = 64, seed: int = 0,
                    half_band: float = 3.0) -> np.ndarray:
    """Narrow-band level set, normalized to [0,1] (0.5 = surface).

    Production VDB assets are predominantly narrow-band SDFs (the other
    big FloatGrid family besides fog volumes): an implicit surface stored
    only within +-half_band voxels of the zero crossing. Built as the SDF
    of a union of noise-displaced spheres; voxels outside the band are 0
    (inactive after sparsification), inside the band the distance is
    remapped linearly so the [0,1]-ranged sigmoid-head model applies
    unchanged — mirroring how a user would normalize SDF leaves for the
    reference pipeline."""
    rng = np.random.default_rng(seed)
    shape = (size, size, size)
    coords = np.mgrid[0:size, 0:size, 0:size].astype(np.float32)
    sdf = np.full(shape, np.inf, np.float32)
    for _ in range(rng.integers(2, 5)):
        center = (0.2 + 0.6 * rng.random(3)) * size
        radius = size * (0.12 + 0.18 * rng.random())
        r = np.sqrt(((coords - center[:, None, None, None]) ** 2).sum(0))
        sdf = np.minimum(sdf, r - radius)
    sdf += (2.0 * fbm_noise(shape, rng, octaves=3, base_cell=size // 8)
            - 1.0) * (0.05 * size)
    band = np.abs(sdf) <= half_band
    out = np.zeros(shape, np.float32)
    # inside-negative convention: surface at 0.5, interior -> 1, exterior -> 0
    out[band] = 0.5 - sdf[band] / (2.0 * half_band)
    return out


def smoke_grid(size: int = 64, seed: int = 0, name: str = "density") -> LeafGrid:
    return _cached_grid("smoke", size, seed, name,
                        lambda: LeafGrid.from_dense(name, smoke_volume(size, seed)))


def levelset_grid(size: int = 64, seed: int = 0, name: str = "surface") -> LeafGrid:
    return _cached_grid("levelset", size, seed, name,
                        lambda: LeafGrid.from_dense(name, levelset_volume(size, seed)))


def velocity_grid(size: int = 64, seed: int = 0, name: str = "vel") -> LeafGrid:
    return _cached_grid("velocity", size, seed, name,
                        lambda: LeafGrid.from_dense(name, velocity_volume(size, seed)))


def make_leaf_dataset_files(out_dir, *, n_volumes: int = 8, size: int = 64,
                            seed: int = 0, channels: int = 1,
                            family: str = "smoke") -> list:
    """Write npy leaf files (reference dataset convention) from procedural
    volumes; returns the list of paths.

    family: "smoke" (fog-volume densities), "levelset" (narrow-band SDFs),
    or "mixed" (alternating) — scalar only; vec3 always uses velocity."""
    from pathlib import Path

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n_volumes):
        if channels == 1:
            fam = family if family != "mixed" else (
                "levelset" if i % 2 else "smoke")
            g = (levelset_grid if fam == "levelset" else smoke_grid)(
                size, seed=seed + i)
            arr = g.leaves[..., 0]
        else:
            g = velocity_grid(size, seed=seed + i)
            arr = g.leaves
        p = out_dir / f"vol_{i:03d}.npy"
        np.save(p, arr)
        paths.append(p)
    return paths
