"""Streaming codec: leaf batches <-> device <-> `.vqvdb` v3 files
(counterpart of `vqvdb_tpu/runtime/codec.py`).

Every device step runs at exactly `CodecConfig.batch_size` leaves (the
ragged tail is zero-padded and cropped on the host). On the card the loop
keeps `PIPELINE_DEPTH` steps in flight: each batch is staged in a pinned
host buffer, copied up, run, and copied back into another pinned buffer
without a wait; the host takes a batch's result only after the next batch
has been enqueued, so host I/O overlaps device work. On the CPU the same
loop runs synchronously.

Encode:  leaves -> encoder features -> score-argmin kernel (the 1x1
         projection folded in) -> u8 indices [B,4,4,4]. The reference
         encoder runs its strided conv folded onto the packed grid
         (`pack_down_conv`) and, for scalar input, its 16-channel residual
         block as the fused kernel (`fuse_rb16`).
         With `fuse_proj_quantize=False`: projection -> nearest-code kernel.
         Residual-VQ models (S stages): projection -> per stage the
         nearest-code and dequantize kernels -> u8 indices [B,4,4,4,S].
Decode:  u8 indices -> dequantize kernel (once per stage, rows summed) ->
         decoder pre-tail -> folded tail GEMM + sigmoid / tanh (or the
         three tail ops with `fuse_decoder_tail=False`).

Every committed `models/*.vqmodel` runs: packed, packed_lite and reference
encoders, scalar and vec3, one or two quantizer stages. Not ported yet: the
packed_stem encoder, `compress_stream`, `decode_stream`, grid/bbox
selection, the v4-v6 tiers and residuals, and the mesh.
"""

from __future__ import annotations

import collections
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vqvdb_tpu_torch.core.config import CodecConfig, LEAF_DIM, ModelConfig
from vqvdb_tpu_torch.core.weights import DeviceLike, params_from_jax
from vqvdb_tpu_torch.format.vqvdb import GridMetadata, VqvdbReader, VqvdbWriter
from vqvdb_tpu_torch.models.quantizer import rvq_dequantize, rvq_indices
from vqvdb_tpu_torch.models.vqvae import (
    check_ported,
    decoder_apply,
    decoder_pre_tail,
    encoder_apply,
    encoder_features,
    encoder_features_packed_down,
)
from vqvdb_tpu_torch.ops.packed import fold_strided_conv
from vqvdb_tpu_torch.ops.quantize import (
    fold_proj_into_scores,
    fused_dequantize,
    fused_nearest_indices,
    fused_score_argmin,
)
from vqvdb_tpu_torch.ops.tail import apply_decoder_tail, fold_decoder_tail
from vqvdb_tpu_torch.utils.errors import ModelMismatchError
from vqvdb_tpu_torch.vdb.grid import LeafGrid

PIPELINE_DEPTH = 2


class _Slot:
    """One pipeline stage's host buffers (pinned on the card) and the event
    that marks its device->host copy done."""

    def __init__(self, in_shape, in_dtype, out_shape, out_dtype,
                 device: torch.device):
        pin = device.type == "cuda"
        self.inp = torch.empty(in_shape, dtype=in_dtype, pin_memory=pin)
        self.out = torch.empty(out_shape, dtype=out_dtype, pin_memory=pin)
        self.out_np = self.out.numpy()
        self.done = torch.cuda.Event() if pin else None


class VQCodec:
    """Bidirectional streaming codec around a trained model.

    `params` is the JAX-layout tree of numpy arrays that
    `core.artifact.load_model` returns. It is converted to tensors on
    `device` (default `cuda`; without a card, pass `device="cpu"` or the
    constructor raises). The exact weight rewrites (folded decoder tail,
    folded projection scores, packed down conv) are computed once here.
    """

    def __init__(self, params: Dict, model_config: ModelConfig,
                 codec_config: Optional[CodecConfig] = None,
                 device: DeviceLike = None) -> None:
        check_ported(model_config)
        self.mcfg = model_config
        self.ccfg = codec_config or CodecConfig()
        self.params = params_from_jax(params, model_config, device)
        self.device = self.params["vq"]["embedding"].device
        self.dtype = self.ccfg.torch_dtype
        # The decode codebook is cast to the compute dtype before the lookup.
        self._codebook = self.params["vq"]["embedding"].to(self.dtype)
        self._folded_tail = None
        if self.ccfg.fuse_decoder_tail:
            self._folded_tail = fold_decoder_tail(self.params["decoder"],
                                                  self.mcfg)
        # Residual-VQ needs the latent itself for its later stages, so the
        # projection folds into the scores only for a single-stage model.
        self._score_mc = None
        if self.ccfg.fuse_proj_quantize and self.mcfg.num_quantizers == 1:
            proj = params["encoder"]["proj"]
            m, c = fold_proj_into_scores(
                np.asarray(proj["w"]), np.asarray(proj["b"]),
                self.params["vq"]["embedding"].cpu().numpy())
            self._score_mc = (m.to(self.device), c.to(self.device))
        # As in the JAX package, the packed down conv rides on the folded
        # projection's encode path.
        self._folded_down = None
        if (self.ccfg.pack_down_conv and self._score_mc is not None
                and self.mcfg.encoder_arch == "reference"):
            down = params["encoder"]["down"]
            self._folded_down = {
                k: v.to(self.device) for k, v in fold_strided_conv(
                    np.asarray(down["w"]), np.asarray(down["b"])).items()}
        self._slots: Dict[str, List[_Slot]] = {}

    # -- device steps ----------------------------------------------------
    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """Encoder features before the folded projection, as the encode
        step takes them: [B,8,8,8,C] -> [B,4,4,4,F]."""
        enc = self.params["encoder"]
        if self._folded_down is not None:
            return encoder_features_packed_down(
                enc, self._folded_down, x, self.mcfg,
                fuse_rb16=self.ccfg.fuse_rb16)
        return encoder_features(enc, x, self.mcfg)

    @torch.inference_mode()
    def _encode_step(self, leaves: torch.Tensor) -> torch.Tensor:
        """[B,8,8,8,C] f32 -> [B,4,4,4] (or [B,4,4,4,S] residual-VQ) uint8."""
        x = leaves.to(self.dtype)
        b = x.shape[0]
        enc = self.params["encoder"]
        if self._score_mc is not None:
            h = self._features(x)
            idx = fused_score_argmin(h.reshape(-1, h.shape[-1]), *self._score_mc)
        else:
            z = encoder_apply(enc, x, self.mcfg)
            flat = z.reshape(-1, self.mcfg.embedding_dim).to(torch.float32)
            if self.mcfg.num_quantizers > 1:
                idx = rvq_indices(flat, self.params["vq"]["embedding"])
            else:
                idx = fused_nearest_indices(flat, self.params["vq"]["embedding"])
        return idx.reshape((b,) + self.mcfg.index_shape).to(torch.uint8)

    @torch.inference_mode()
    def _decode_step(self, indices: torch.Tensor) -> torch.Tensor:
        """[B,4,4,4] (or [B,4,4,4,S] residual-VQ) uint8 -> [B,8,8,8,C] f32."""
        b = indices.shape[0]
        if self.mcfg.num_quantizers > 1:
            z = rvq_dequantize(indices.reshape(-1, self.mcfg.num_quantizers),
                               self._codebook)
        else:
            z = fused_dequantize(indices.reshape(-1), self._codebook)
        z = z.reshape((b,) + self.mcfg.latent_shape + (self.mcfg.embedding_dim,))
        dec = self.params["decoder"]
        if self._folded_tail is not None:
            h = decoder_pre_tail(dec, z, self.mcfg)
            return apply_decoder_tail(self._folded_tail, h, self.mcfg)
        return decoder_apply(dec, z, self.mcfg)

    # -- latent-shape self-check -----------------------------------------
    def check_latent_shape(self) -> Tuple[int, ...]:
        """Run a zero leaf through the encoder; the index shape must match
        the config."""
        probe = torch.zeros((1, LEAF_DIM, LEAF_DIM, LEAF_DIM, self.mcfg.in_channels),
                            dtype=torch.float32, device=self.device)
        got = tuple(self._encode_step(probe).shape[1:])
        if got != self.mcfg.index_shape:
            raise ModelMismatchError(
                f"latent-shape probe mismatch: model produced {got}, "
                f"config declares {self.mcfg.index_shape}")
        return got

    # -- pipelined batches -----------------------------------------------
    def _slots_for(self, kind: str) -> List[_Slot]:
        if kind not in self._slots:
            bs = self.ccfg.batch_size
            leaf = (bs, LEAF_DIM, LEAF_DIM, LEAF_DIM, self.mcfg.in_channels)
            idx = (bs,) + self.mcfg.index_shape
            shapes = ((leaf, torch.float32, idx, torch.uint8) if kind == "encode"
                      else (idx, torch.uint8, leaf, torch.float32))
            self._slots[kind] = [_Slot(*shapes, self.device)
                                 for _ in range(PIPELINE_DEPTH)]
        return self._slots[kind]

    def _pipelined(self, kind: str, batches: Iterable[Tuple[np.ndarray, object]]
                   ) -> Iterator[Tuple[np.ndarray, object, int]]:
        """Run each (host batch of <= batch_size rows, tag) through the
        encode or decode step; yields (host result rows, tag, n). A yielded
        array is a view of a reused buffer: use it before the next one."""
        step: Callable = self._encode_step if kind == "encode" else self._decode_step
        slots = self._slots_for(kind)
        cuda = self.device.type == "cuda"
        pending: collections.deque = collections.deque()
        dispatched = 0
        for chunk, tag in batches:
            n = chunk.shape[0]
            if n == 0:
                continue
            # A slot is reused only after _collect has waited on its event.
            slot = slots[dispatched % PIPELINE_DEPTH]
            dispatched += 1
            slot.inp[:n].copy_(torch.from_numpy(np.ascontiguousarray(chunk)))
            slot.inp[n:].zero_()
            res = step(slot.inp.to(self.device, non_blocking=True))
            slot.out.copy_(res, non_blocking=cuda)
            if cuda:
                slot.done.record()
            pending.append((slot, tag, n))
            if len(pending) >= PIPELINE_DEPTH:
                yield self._collect(pending.popleft())
        while pending:
            yield self._collect(pending.popleft())

    @staticmethod
    def _collect(item) -> Tuple[np.ndarray, object, int]:
        slot, tag, n = item
        if slot.done is not None:
            slot.done.synchronize()
        return slot.out_np[:n], tag, n

    def _batches(self, data: np.ndarray):
        bs = self.ccfg.batch_size
        for s in range(0, data.shape[0], bs):
            yield data[s: s + bs], s

    # -- array-level API -------------------------------------------------
    def encode_leaves(self, leaves: np.ndarray) -> np.ndarray:
        """Encode [N,8,8,8,C] (or [N,8,8,8]) f32 -> [N,4,4,4] u8
        ([N,4,4,4,S] residual-VQ), batched."""
        leaves = np.asarray(leaves, np.float32)
        if leaves.ndim == 4:
            leaves = leaves[..., None]
        out = np.empty((leaves.shape[0],) + self.mcfg.index_shape,
                       self.mcfg.index_dtype)
        for rows, s, n in self._pipelined("encode", self._batches(leaves)):
            out[s: s + n] = rows
        return out

    def decode_indices(self, indices: np.ndarray) -> np.ndarray:
        """Decode [N,4,4,4] (or [N,4,4,4,S]) u8 -> [N,8,8,8,C] f32, batched."""
        indices = np.asarray(indices, self.mcfg.index_dtype)
        out = np.empty((indices.shape[0], LEAF_DIM, LEAF_DIM, LEAF_DIM,
                        self.mcfg.in_channels), np.float32)
        for rows, s, n in self._pipelined("decode", self._batches(indices)):
            out[s: s + n] = rows
        return out

    # -- file-level API --------------------------------------------------
    def compress(
        self,
        grids: Union[LeafGrid, Sequence[LeafGrid]],
        out_path: Union[str, Path],
        *,
        should_stop: Optional[Callable[[], bool]] = None,
    ) -> dict:
        """Encode grids and stream them to a `.vqvdb` v3 file.

        should_stop (checked between batches) requests a graceful abort:
        batches written so far are kept, the open grid's block count is
        patched (VqvdbWriter.abort_grid), later grids are skipped, and the
        stats dict says "aborted": True.
        Returns {leaves, seconds, leaves_per_sec, bytes, aborted}.
        """
        if isinstance(grids, LeafGrid):
            grids = [grids]
        stop = should_stop if should_stop is not None else (lambda: False)
        aborted = False
        t0 = time.perf_counter()
        total = 0
        with VqvdbWriter(out_path) as w:
            for grid in grids:
                if aborted:
                    break
                w.start_grid(GridMetadata(
                    name=grid.name, num_embeddings=self.mcfg.num_embeddings,
                    latent_shape=self.mcfg.index_shape,
                    total_blocks=grid.num_leaves, transform=grid.transform))
                for idx, s, n in self._pipelined("encode",
                                                 self._batches(grid.leaves)):
                    if stop():
                        aborted = True
                        break
                    w.write_batch(idx, grid.origins[s: s + n])
                    total += n
                w.abort_grid() if aborted else w.end_grid()
        dt = time.perf_counter() - t0
        return {
            "leaves": total,
            "seconds": dt,
            "leaves_per_sec": total / dt if dt > 0 else float("inf"),
            "bytes": Path(out_path).stat().st_size,
            "aborted": aborted,
        }

    def decompress(self, in_path: Union[str, Path]) -> Tuple[List[LeafGrid], dict]:
        """Decode every grid of a `.vqvdb` v3 file into LeafGrids.
        Returns (grids, {leaves, seconds, leaves_per_sec})."""
        t0 = time.perf_counter()
        out_grids: List[LeafGrid] = []
        total = 0
        bs = self.ccfg.batch_size
        with VqvdbReader(in_path) as r:
            if r.num_embeddings != self.mcfg.num_embeddings:
                raise ModelMismatchError(
                    f"file has {r.num_embeddings} embeddings, model has "
                    f"{self.mcfg.num_embeddings}")
            while r.has_next_grid():
                meta = r.next_grid_metadata()
                if tuple(meta.latent_shape) != self.mcfg.index_shape:
                    raise ModelMismatchError(
                        f"file latent shape {meta.latent_shape} != model "
                        f"{self.mcfg.index_shape}")
                leaves = np.empty((meta.total_blocks, LEAF_DIM, LEAF_DIM,
                                   LEAF_DIM, self.mcfg.in_channels), np.float32)
                origins = np.empty((meta.total_blocks, 3), np.int32)

                def batches():
                    cursor = 0
                    while r.has_next():
                        idx, org = r.next_batch(bs)
                        origins[cursor: cursor + idx.shape[0]] = org
                        yield idx, cursor
                        cursor += idx.shape[0]

                for rows, s, n in self._pipelined("decode", batches()):
                    leaves[s: s + n] = rows
                    total += n
                out_grids.append(LeafGrid(name=meta.name, origins=origins,
                                          leaves=leaves, transform=meta.transform))
        dt = time.perf_counter() - t0
        return out_grids, {
            "leaves": total,
            "seconds": dt,
            "leaves_per_sec": total / dt if dt > 0 else float("inf"),
        }
