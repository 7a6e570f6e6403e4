"""Command-line interface (counterpart of `vqvdb_tpu/cli.py`): train /
datagen / eval / encode / decode / info / verify / transcode / sequences /
OpenVDB tools / bench / serve / torch and ONNX import and export.

    python -m vqvdb_tpu_torch.cli datagen data/ --volumes 8
    python -m vqvdb_tpu_torch.cli train --data-dir data/ --model-path out/m.vqmodel
    python -m vqvdb_tpu_torch.cli eval --data-dir data/ --model out/m.vqmodel
    python -m vqvdb_tpu_torch.cli encode scene.vdb scene.vqvdb --model m.vqmodel
    python -m vqvdb_tpu_torch.cli decode scene.vqvdb recon.vdb --model m.vqmodel
    python -m vqvdb_tpu_torch.cli info scene.vqvdb
    python -m vqvdb_tpu_torch.cli bench
    python -m vqvdb_tpu_torch.cli serve --model m.vqmodel --port 8990
    python -m vqvdb_tpu_torch.cli export-onnx m.vqmodel onnx/ --embed-header onnx/bin_onnx.h
    python -m vqvdb_tpu_torch.cli import-torch ref.pth m.vqmodel

Every subcommand that runs a model or places its weights takes `--device`
(default `cuda`; `cpu` runs the kernels' plain versions). The kernels are
built into the directory `utils/compile_cache.py` chooses
(VQVDB_COMPILE_CACHE). Output is one JSON object, with the JAX
CLI's keys and, where the codec reports them, `host_seconds`,
`group_norm_launches` and (decode) `direct_readback_share` and
`pinned_pool_growth`; `train` logs its
epochs and writes the model, its `.history.json` and checkpoints (the
port's own format, train/checkpoint.py). Exit codes are the JAX CLI's: 0
done, 1 a file or model error, 2 a usage error, 130 an encode stopped by
^C; `export-onnx` exits 3 when its graphs fail validation.

`--data-parallel` shards each device step of `encode`, `decode`,
`encode-seq` and `decode-seq` over every local card (`parallel/mesh.py`;
files byte-identical to one card's). On `train` (host loop or
`--device-resident`) it starts one NCCL rank per visible card with
`torch.multiprocessing`, or, under `torch.distributed.run` (WORLD_SIZE set),
joins the launcher's ranks; rank 0 writes the checkpoints and the model.
With one card, or `--device cpu`, it trains in this process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

from vqvdb_tpu_torch.utils.errors import VqvdbError


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _rounded(stats: dict, digits: int = 2) -> dict:
    return {k: round(v, digits) if isinstance(v, float) else v for k, v in stats.items()}


def _make_codec(args):
    from vqvdb_tpu_torch import api

    return api.make_codec(args.model, batch_size=args.batch_size,
                          compute_dtype=args.compute_dtype, device=args.device,
                          data_parallel=getattr(args, "data_parallel", False))


def _load_one_grid(f: Path):
    """An npy file as a LeafGrid: a leaf array ([N,8,8,8] or [N,8,8,8,C])
    with its sidecars, or else a dense volume ([X,Y,Z] or [X,Y,Z,C]),
    sparsified."""
    from vqvdb_tpu_torch.vdb.grid import LeafGrid

    arr = np.load(f, mmap_mode="r")
    if arr.ndim >= 4 and arr.shape[1:4] == (8, 8, 8):
        return LeafGrid.load_npy(f)
    return LeafGrid.from_dense(f.stem, np.asarray(arr))


def _load_vdb(path: Path):
    from vqvdb_tpu_torch.vdb.openvdb_io import read_vdb_leafgrids

    grids = read_vdb_leafgrids(path)
    for g in grids:
        dropped = getattr(g, "dropped_tiles", 0)
        if dropped:
            print(f"warning: grid '{g.name}': {dropped} active constant tile(s) larger "
                  "than a leaf were dropped (the VQ codec compresses 8^3 leaves only)",
                  file=sys.stderr)
    return grids


def _load_grids(path: Path, grid_name):
    if path.is_dir():
        grids = [_load_one_grid(f) for f in sorted(path.glob("*.npy"))
                 if not f.name.endswith("_origins.npy")]
        for f in sorted(path.glob("*.vdb")):
            grids.extend(_load_vdb(f))
    elif path.suffix == ".vdb":
        grids = _load_vdb(path)
    else:
        grids = [_load_one_grid(path)]
    if grid_name:
        grids = [g for g in grids if g.name == grid_name]
    return grids


class _GracefulInterrupt:
    """SIGINT -> graceful encode abort: the first ^C asks the codec to stop
    between batches (what was encoded is kept and the file is finalized
    valid, VqvdbWriter.abort_grid); a second ^C raises KeyboardInterrupt."""

    def __enter__(self):
        import signal

        self.stopped = False

        def handler(signum, frame):
            if self.stopped:
                raise KeyboardInterrupt
            self.stopped = True
            print("interrupt: finishing current batch and finalizing the archive "
                  "(^C again to kill)", file=sys.stderr)

        self._prev = signal.signal(signal.SIGINT, handler)
        return self

    def __exit__(self, *exc):
        import signal

        # A handler installed from C reads as None, which signal.signal
        # does not take back: leave the default in place.
        signal.signal(signal.SIGINT, signal.SIG_DFL if self._prev is None else self._prev)

    def __call__(self) -> bool:
        return self.stopped


def _cmd_encode(args) -> int:
    from vqvdb_tpu_torch import api

    codec = _make_codec(args)
    opts = dict(progress=args.verbose, format_version=args.format_version,
                compression=args.v5_codec, residual=args.residual,
                residual_tol=args.residual_tol)
    if args.streaming:
        if Path(args.input).suffix != ".vdb":
            return _error("--streaming requires a .vdb input")
        from vqvdb_tpu_torch.vdb.openvdb_io import open_vdb_leaf_streams

        streams = open_vdb_leaf_streams(args.input, names=args.grid or None)
        if not streams:
            return _error("no grids matched")
        for s in streams:
            if s.dropped_tiles:
                print(f"warning: grid '{s.name}': {s.dropped_tiles} active constant "
                      "tile(s) larger than a leaf were dropped", file=sys.stderr)
        with _GracefulInterrupt() as stop:
            stats = codec.compress_stream(streams, args.output, should_stop=stop, **opts)
        print(json.dumps({"grids": len(streams), **_rounded(stats)}))
        return 130 if stats["aborted"] else 0
    grids = _load_grids(Path(args.input), args.grid)
    if not grids:
        return _error("no grids matched")
    with _GracefulInterrupt() as stop:
        stats = api.encode(grids, codec, args.output, should_stop=stop, **opts)
    print(json.dumps({"grids": len(grids), **_rounded(stats)}))
    return 130 if stats["aborted"] else 0


def _cmd_decode(args) -> int:
    from vqvdb_tpu_torch import api

    codec = _make_codec(args)
    bbox = None
    if args.bbox:
        v = [int(x) for x in args.bbox.split(",")]
        if len(v) != 6:
            return _error("--bbox wants x0,y0,z0,x1,y1,z1")
        bbox = (v[:3], v[3:])
    grids, stats = api.decode(args.input, codec, progress=args.verbose,
                              grids=args.grid or None, bbox=bbox)
    out_path = Path(args.output)
    if args.vdb or out_path.suffix == ".vdb":
        from vqvdb_tpu_torch.vdb.openvdb_io import write_vdb_leafgrids

        out_path.parent.mkdir(parents=True, exist_ok=True)
        write_vdb_leafgrids(out_path, grids)
        print(json.dumps({"grids": [g.name for g in grids], "vdb": str(out_path),
                          **_rounded(stats)}))
        return 0
    out_path.mkdir(parents=True, exist_ok=True)
    for g in grids:
        if args.dense:
            dense, lo = g.to_dense()
            np.save(out_path / f"{g.name}.dense.npy",
                    dense[..., 0] if dense.shape[-1] == 1 else dense)
            (out_path / f"{g.name}.origin.json").write_text(
                json.dumps({"min_corner": lo.tolist()}))
        else:
            g.save_npy(out_path / f"{g.name}.npy")
    print(json.dumps({"grids": [g.name for g in grids], **_rounded(stats)}))
    return 0


def _cmd_encode_seq(args) -> int:
    from vqvdb_tpu_torch import api

    files = sorted(Path(args.input_dir).glob(args.glob))
    if not files:
        return _error(f"no files match {args.glob} in {args.input_dir}")
    frames = []
    for f in files:
        grids = _load_grids(f, args.grid)
        if not grids:
            return _error(f"no grids matched in {f}")
        frames.append(grids)
    codec = _make_codec(args)
    stats = api.encode_sequence(frames, codec, args.output_dir, pattern=args.pattern,
                                format_version=args.format_version,
                                compression=args.v5_codec, residual=args.residual)
    stats["inputs"] = [f.name for f in files]
    print(json.dumps(_rounded(stats, 4)))
    return 0


def _cmd_decode_seq(args) -> int:
    from vqvdb_tpu_torch import api

    codec = _make_codec(args)
    frames, stats = api.decode_sequence(args.input_dir, codec, pattern=args.pattern)
    if not frames:
        return _error(f"no files match {args.pattern} in {args.input_dir}")
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, grids in enumerate(frames):
        if args.vdb:
            from vqvdb_tpu_torch.vdb.openvdb_io import write_vdb_leafgrids

            write_vdb_leafgrids(out_dir / f"frame_{i:04d}.vdb", grids)
        else:
            frame_dir = out_dir / f"frame_{i:04d}"
            frame_dir.mkdir(exist_ok=True)
            for g in grids:
                g.save_npy(frame_dir / f"{g.name}.npy")
    print(json.dumps(_rounded(stats, 4)))
    return 0


def _cmd_vdbinfo(args) -> int:
    from vqvdb_tpu_torch.vdb.openvdb_io import read_vdb_info

    print(json.dumps(read_vdb_info(args.input), indent=2))
    return 0


def _cmd_transcode(args) -> int:
    from vqvdb_tpu_torch.format.transcode import transcode

    stats = transcode(args.input, args.output, version=args.format_version,
                      compression=args.v5_codec, drop_residual=args.drop_residual,
                      grids=args.grid or None)
    print(json.dumps(stats))
    return 0


def _cmd_info(args) -> int:
    from vqvdb_tpu_torch.format.vqvdb import RESIDUAL_MODE_NAMES, VqvdbReader

    with VqvdbReader(args.input) as r:
        out = {"version": r.version, "num_grids": r.num_grids,
               "num_embeddings": r.num_embeddings,
               "latent_dim_count": r.latent_dim_count, "grids": []}
        while r.has_next_grid():
            meta = r.next_grid_metadata()
            entry = {"name": meta.name, "latent_shape": list(meta.latent_shape),
                     "total_blocks": meta.total_blocks, "chunk_bytes": meta.chunk_size}
            if meta.residual_mode:
                entry["residual"] = RESIDUAL_MODE_NAMES[meta.residual_mode]
                entry["residual_channels"] = meta.residual_channels
            # the bytes on disk: total_blocks * chunk_bytes for v3/v4, the
            # compressed frames for v5/v6
            payload = r.skip_grid_payload()
            entry["payload_bytes"] = payload
            if r.grid_codec is not None:
                entry["payload_codec"] = r.grid_codec
                if payload:
                    entry["frame_compression"] = round(
                        meta.total_blocks * meta.chunk_size / payload, 3)
            out["grids"].append(entry)
    print(json.dumps(out, indent=2))
    return 0


def _cmd_verify(args) -> int:
    from vqvdb_tpu_torch.format.verify import verify_container, verify_roundtrip

    in_path = Path(args.input)
    if in_path.is_dir():
        if args.against is not None:
            return _error("--against takes a single archive, not a directory")
        frames = sorted(in_path.glob("*.vqvdb"))
        if not frames:
            return _error("no .vqvdb files in directory")
        reports = [verify_container(f) for f in frames]
        out = {"ok": all(r["ok"] for r in reports), "files": reports}
    elif args.against is None:
        out = verify_container(args.input)
    else:
        if args.model is None:
            return _error("--against requires --model")
        sources = _load_grids(Path(args.against), args.grid)
        if not sources:
            return _error("no source grids matched")
        out = verify_roundtrip(args.input, _make_codec(args), sources)
    print(json.dumps(out, indent=2))
    return 0 if out["ok"] else 1


def _cmd_bench(args) -> int:
    from vqvdb_tpu_torch import bench

    bench.main(device=args.device)
    return 0


def _cmd_extract(args) -> int:
    """.vdb assets -> the .npy leaf layout with origins sidecars, one file
    per grid."""
    from vqvdb_tpu_torch.vdb.openvdb_io import read_vdb_leafgrids

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    inputs = []
    for item in args.inputs:
        p = Path(item)
        inputs.extend(sorted(p.glob("*.vdb")) if p.is_dir() else [p])
    if not inputs:
        return _error("no .vdb inputs")
    written, total, used = [], 0, set()
    for p in inputs:
        for g in read_vdb_leafgrids(p):
            if args.grid and g.name != args.grid:
                continue
            # Grid names may repeat within a file: never overwrite.
            stem, k = f"{p.stem}_{g.name}", 2
            while stem in used:
                stem = f"{p.stem}_{g.name}_{k}"
                k += 1
            used.add(stem)
            out = out_dir / f"{stem}.npy"
            g.save_npy(out)
            written.append(str(out))
            total += int(g.leaves.shape[0])
    print(json.dumps({"files": len(written), "leaves": total, "dir": str(out_dir)}))
    return 0 if written else 2


def _cmd_train(args) -> int:
    if args.data_parallel:
        return _train_data_parallel(args)
    return _train(args)


def _train(args, mesh=None) -> int:
    """The training run of this process (this rank's part under `mesh`);
    rank 0 writes the model."""
    from vqvdb_tpu_torch.core.artifact import save_model
    from vqvdb_tpu_torch.core.config import ModelConfig
    from vqvdb_tpu_torch.train.checkpoint import CheckpointManager
    from vqvdb_tpu_torch.train.data import LeafDataset, find_npy_files
    from vqvdb_tpu_torch.train.train import TrainConfig, train

    rank = 0 if mesh is None else mesh.first_shard
    say = print if rank == 0 else (lambda *_: None)
    files = find_npy_files(args.data_dir)
    if not files:
        return _error(f"no .npy files in {args.data_dir}")
    say(f"found {len(files)} .npy files")
    ds = LeafDataset(files, in_channels=args.in_channels, stride=args.stride)
    say(f"dataset: {len(ds)} leaves")
    mcfg = ModelConfig(in_channels=args.in_channels, embedding_dim=args.embedding_dim,
                       num_embeddings=args.num_embeddings,
                       num_quantizers=args.num_quantizers, encoder_arch=args.encoder_arch)
    tcfg = TrainConfig(epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                       compute_dtype=args.compute_dtype, pool_dtype=args.pool_dtype,
                       pool_segments=args.pool_segments, val_fraction=args.val_fraction,
                       seed=args.seed)
    ckpt_dir = args.checkpoint_dir or str(Path(args.model_path).parent / "ckpts")
    if args.device_resident:
        from vqvdb_tpu_torch.train.fast import train_on_device

        if mesh is not None:
            say(f"data-parallel device-resident over {mesh.size} devices")
        state, trace = train_on_device(ds.gather(np.arange(len(ds))), mcfg, tcfg,
                                       checkpoint_dir=ckpt_dir, resume=not args.no_resume,
                                       mesh=mesh, log_fn=say, device=args.device)
        history = {"loss": trace[:, 0].tolist(), "recon": trace[:, 1].tolist(),
                   "vq": trace[:, 2].tolist(), "perplexity": trace[:, 3].tolist(),
                   "val_loss": trace[:, 4].tolist()}
    else:
        if mesh is not None:
            say(f"data-parallel over {mesh.size} devices")
        state, history = train(ds, mcfg, tcfg, checkpoint_dir=ckpt_dir,
                               resume=not args.no_resume, mesh=mesh, log_fn=say,
                               device=args.device)
    if rank:
        return 0
    Path(args.model_path).parent.mkdir(parents=True, exist_ok=True)
    # Model selection: the best-val state where one was recorded, else the
    # final state.
    export_params = state.params
    manager = CheckpointManager(ckpt_dir)
    best = manager.restore_best(state)
    if best is not None:
        bstep, bstate = best
        meta = manager.read_best_metrics() or {}
        print(f"exporting best-val checkpoint: step {bstep} "
              f"val={meta.get('val_loss', float('nan')):.6f}")
        export_params = bstate.params
    save_model(args.model_path, export_params, mcfg)
    print(f"model saved to {args.model_path}")
    Path(args.model_path).with_suffix(".history.json").write_text(json.dumps(history))
    return 0


def _train_data_parallel(args) -> int:
    """train --data-parallel: join torch.distributed.run's ranks, or start
    one NCCL rank per visible card, or (one card, or the CPU) train here on
    a mesh of one device."""
    import torch

    from vqvdb_tpu_torch.parallel.distributed import init_multi_host
    from vqvdb_tpu_torch.parallel.mesh import make_mesh

    cpu = torch.device(args.device).type == "cpu"
    if "WORLD_SIZE" in os.environ:
        init_multi_host("env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                        backend="gloo" if cpu else "nccl")
        return _train(args, make_mesh(device="cpu" if cpu else None))
    n = 1 if cpu else torch.cuda.device_count()
    if n <= 1:
        return _train(args, make_mesh(device=args.device))
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        # A file store in a fresh directory: no port to find or to collide on.
        mp.spawn(_train_rank, args=(n, f"file://{tmp}/store", args), nprocs=n)
    return 0


def _train_rank(rank: int, world: int, init_method: str, args) -> None:
    """One rank of train --data-parallel (a torch.multiprocessing child)."""
    import torch.distributed as dist

    from vqvdb_tpu_torch.parallel.distributed import init_multi_host
    from vqvdb_tpu_torch.parallel.mesh import make_mesh

    os.environ["LOCAL_RANK"] = str(rank)
    init_multi_host(init_method, world, rank, backend="nccl")
    try:
        rc = _train(args, make_mesh())
    finally:
        dist.destroy_process_group()
    if rc:
        raise SystemExit(rc)


def _cmd_datagen(args) -> int:
    """Procedural training data (npy leaf files)."""
    from vqvdb_tpu_torch.train.synthetic import make_leaf_dataset_files

    paths = make_leaf_dataset_files(args.out_dir, n_volumes=args.volumes, size=args.size,
                                    seed=args.seed, channels=args.channels,
                                    family=args.family)
    total = sum(int(np.load(p, mmap_mode="r").shape[0]) for p in paths)
    print(json.dumps({"files": len(paths), "leaves": total, "dir": str(args.out_dir)}))
    return 0


def _cmd_eval(args) -> int:
    """Quality evaluation of a model over a leaf dataset (JSON; with
    --report-dir also the plots and report.md)."""
    import torch

    from vqvdb_tpu_torch.eval.metrics import codebook_report, evaluate_codec
    from vqvdb_tpu_torch.train.data import LeafDataset, find_npy_files

    files = find_npy_files(args.data_dir)
    if not files:
        return _error(f"no .npy files in {args.data_dir}")
    ds = LeafDataset(files, in_channels=args.in_channels, stride=args.stride)
    leaves = ds.gather(np.arange(min(len(ds), args.max_leaves)))
    codec = _make_codec(args)
    report = evaluate_codec(codec, leaves)
    mcfg = codec.mcfg
    cb = codebook_report(report["indices"], mcfg.num_embeddings)
    if args.report_dir:
        from vqvdb_tpu_torch.eval.report import write_report
        from vqvdb_tpu_torch.models.vqvae import encoder_apply

        # 512 leaves feed the latent and error diagnostics; the montage
        # takes the first 6.
        k = min(512, leaves.shape[0])
        sample = leaves[:k]
        recon = codec.decode_indices(report["indices"][:k])
        with torch.no_grad():
            z = encoder_apply(codec.params["encoder"],
                              torch.from_numpy(sample).to(codec.device), mcfg)
        report["latent_sample"] = z.cpu().numpy().reshape(-1, mcfg.embedding_dim)
        cb["embedding"] = codec.params["vq"]["embedding"].cpu().numpy().reshape(
            -1, mcfg.embedding_dim)
        if mcfg.num_quantizers > 1:
            # One PCA point per (stage, code): recolour per stage.
            idx = np.asarray(report["indices"]).reshape(-1, mcfg.num_quantizers)
            cb["pca_counts"] = np.concatenate([
                np.bincount(idx[:, s], minlength=mcfg.num_embeddings)
                for s in range(mcfg.num_quantizers)]).astype(np.float64)
        md = write_report(args.report_dir, report, cb, sample_leaves=sample,
                          sample_recon=recon, title=f"eval: {args.model}")
        print(f"report written to {md}", file=sys.stderr)
    out = {k: v for k, v in report.items() if not isinstance(v, np.ndarray)}
    out.update({k: v for k, v in cb.items() if not isinstance(v, np.ndarray)})
    print(json.dumps(out, indent=2))
    return 0


def _cmd_serve(args) -> int:
    """Run the codec as an HTTP service (serving.py)."""
    from vqvdb_tpu_torch.serving import serve

    serve(_make_codec(args), host=args.host, port=args.port)
    return 0


def _cmd_import_torch(args) -> int:
    """Convert a reference torch checkpoint (.pth) to a .vqmodel artifact."""
    from vqvdb_tpu_torch.core.artifact import save_model
    from vqvdb_tpu_torch.core.config import ModelConfig
    from vqvdb_tpu_torch.core.torch_import import import_torch_checkpoint
    from vqvdb_tpu_torch.core.weights import params_from_jax

    cfg = ModelConfig(in_channels=args.in_channels, embedding_dim=args.embedding_dim,
                      num_embeddings=args.num_embeddings)
    params = params_from_jax(import_torch_checkpoint(args.checkpoint, cfg), cfg, args.device)
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    save_model(args.output, params, cfg)
    print(json.dumps({"imported": str(args.checkpoint), "model": str(args.output)}))
    return 0


def _cmd_export_checkpoint(args) -> int:
    """Export a training checkpoint of this package (train/checkpoint.py) to
    a .vqmodel inference artifact."""
    from vqvdb_tpu_torch.core.artifact import save_model
    from vqvdb_tpu_torch.core.config import ModelConfig
    from vqvdb_tpu_torch.train.checkpoint import CheckpointManager
    from vqvdb_tpu_torch.train.train import TrainConfig, make_train_state

    mcfg = ModelConfig(in_channels=args.in_channels, embedding_dim=args.embedding_dim,
                       num_embeddings=args.num_embeddings,
                       num_quantizers=args.num_quantizers, encoder_arch=args.encoder_arch)
    template = make_train_state(mcfg, TrainConfig(), 1, device=args.device)
    manager = CheckpointManager(args.checkpoint_dir)
    if args.best:
        restored = manager.restore_best(template)
        if restored is None:
            return _error(f"no best/ checkpoint in {args.checkpoint_dir}")
        step, state = restored
    else:
        step = args.step if args.step is not None else manager.latest_step()
        if step is None:
            return _error(f"no checkpoints in {args.checkpoint_dir}")
        state = manager.restore(step, template)
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    save_model(args.output, state.params, mcfg)
    print(json.dumps({"checkpoint_step": int(step), "best": bool(args.best),
                      "model": str(args.output)}))
    return 0


def _cmd_export_torch(args) -> int:
    """Export a .vqmodel to reference-runtime torch artifacts: a state_dict
    checkpoint (.pth, reference trainer layout) and/or a TorchScript module
    (.pt with encode/decode, the input of the reference's to_onnx.py)."""
    from vqvdb_tpu_torch.core.artifact import load_model
    from vqvdb_tpu_torch.core.weights import params_from_jax
    from vqvdb_tpu_torch.interop import save_reference_checkpoint, save_torchscript

    tree, cfg = load_model(args.model)
    params = params_from_jax(tree, cfg, args.device)
    out = {}
    if args.checkpoint:
        Path(args.checkpoint).parent.mkdir(parents=True, exist_ok=True)
        save_reference_checkpoint(args.checkpoint, params, cfg)
        out["checkpoint"] = str(args.checkpoint)
    if args.torchscript:
        Path(args.torchscript).parent.mkdir(parents=True, exist_ok=True)
        save_torchscript(args.torchscript, params, cfg)
        out["torchscript"] = str(args.torchscript)
    if not out:
        return _error("pass --checkpoint and/or --torchscript")
    print(json.dumps(out))
    return 0


def _validate_onnx(paths, tree, cfg, device) -> dict:
    """The exported graphs, run by the numpy evaluator, against the port's
    encode_to_indices / decode_from_indices on `device` in f32 with TF32
    off, on 4 seeded leaves."""
    import torch

    from vqvdb_tpu_torch.core.weights import params_from_jax
    from vqvdb_tpu_torch.interop.onnx_eval import run_model
    from vqvdb_tpu_torch.models.vqvae import decode_from_indices, encode_to_indices

    params = params_from_jax(tree, cfg, device)
    dev = params["vq"]["embedding"].device
    x = np.random.default_rng(0).random((4, 8, 8, 8, cfg.in_channels), np.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want_idx = encode_to_indices(params, torch.from_numpy(x).to(dev), cfg)
            want = decode_from_indices(params, want_idx, cfg).cpu().numpy()
        want_idx = want_idx.cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    got_idx = run_model(paths["encoder"], {"input": np.moveaxis(x, -1, 1)})["output"]
    idx_match = float(np.mean(want_idx == got_idx))
    got = run_model(paths["decoder"], {"input": want_idx.astype(got_idx.dtype)})["output"]
    dec_err = float(np.abs(np.moveaxis(got, 1, -1) - want).max())
    return {"encoder_index_agreement": idx_match, "decoder_max_abs_err": dec_err,
            "valid": bool(idx_match == 1.0 and dec_err < 1e-5)}


def _cmd_export_onnx(args) -> int:
    """Emit encoder.onnx/decoder.onnx from a .vqmodel and (by default)
    validate them against the port's model at atol 1e-5 (exit 3 if not)."""
    from vqvdb_tpu_torch.core.artifact import load_model
    from vqvdb_tpu_torch.interop import export_onnx

    tree, cfg = load_model(args.model)
    paths = export_onnx(args.output_dir, tree, cfg)
    result = dict(paths)
    if args.embed_header:
        from vqvdb_tpu_torch.interop.embed import write_embed_header

        hdr = write_embed_header(args.embed_header, {
            "encoder_model_data": paths["encoder"],
            "decoder_model_data": paths["decoder"],
        })
        result["embed_header"] = str(hdr)
    if not args.no_validate:
        result.update(_validate_onnx(paths, tree, cfg, args.device))
        if not result["valid"]:
            print(json.dumps(result))
            return 3
    print(json.dumps(result))
    return 0


def _device_option(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (default) or cpu")


def _codec_options(p) -> None:
    _device_option(p)
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--compute-dtype", default="bfloat16")


def _tier_options(p, *, tol: bool = True) -> None:
    p.add_argument("--format-version", type=int, default=None, choices=[3, 4, 5, 6],
                   help="container version: default 3 (4 for K > 256; 6 with "
                        "--residual); 5 compresses the index frames")
    p.add_argument("--v5-codec", default="zlib", choices=["zlib", "lzma", "lz4"],
                   help="frame codec of v5/v6 files")
    p.add_argument("--residual", default=None, choices=["int8", "f16"],
                   help="the v6 near-lossless tier: store a per-leaf correction")
    if tol:
        p.add_argument("--residual-tol", type=float, default=None,
                       help="int8 tier: floor of the quantization step at 2 x tol")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vqvdb_tpu_torch",
                                description="VQ-VAE volume codec on PyTorch / CUDA")
    sub = p.add_subparsers(dest="command", required=True)

    pt = sub.add_parser("train", help="Train the VQ-VAE model.")
    pt.add_argument("--data-dir", required=True, help="directory with .npy leaf files")
    pt.add_argument("--model-path", default="models/vqvae.vqmodel")
    pt.add_argument("--checkpoint-dir", default=None,
                    help="default: ckpts/ beside --model-path")
    pt.add_argument("--epochs", type=int, default=30)
    pt.add_argument("--batch-size", type=int, default=2048)
    pt.add_argument("--lr", type=float, default=1e-4)
    pt.add_argument("--num-embeddings", type=int, default=256)
    pt.add_argument("--num-quantizers", type=int, default=1,
                    help="residual-VQ stages: 1 = the reference architecture; 2+ = "
                         "S bytes per latent position (effective codebook K^S)")
    pt.add_argument("--embedding-dim", type=int, default=128)
    pt.add_argument("--encoder-arch", default="reference",
                    choices=["reference", "packed", "packed_lite", "packed_stem"],
                    help="encoder graph family")
    pt.add_argument("--in-channels", type=int, default=1, choices=[1, 3])
    pt.add_argument("--stride", type=int, default=1, help="dataset subsample stride")
    pt.add_argument("--compute-dtype", default="bfloat16")
    pt.add_argument("--pool-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="dtype of the device-resident pool (--device-resident only)")
    pt.add_argument("--pool-segments", type=int, default=1,
                    help="--device-resident only: each dead-code interval runs over "
                         "1/S of the pool, rotating (TrainConfig.pool_segments)")
    pt.add_argument("--val-fraction", type=float, default=0.2,
                    help="held-out fraction for validation and best-val selection")
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--device", default="cuda",
                    help="where training runs: cuda (default) or cpu")
    pt.add_argument("--data-parallel", action="store_true",
                    help="one rank per local card, batches sharded over them")
    pt.add_argument("--device-resident", action="store_true",
                    help="keep the whole dataset in device memory (train/fast.py)")
    pt.add_argument("--no-resume", action="store_true")
    pt.set_defaults(func=_cmd_train)

    pv = sub.add_parser("eval", help="Quality evaluation over a leaf dataset.")
    pv.add_argument("--data-dir", required=True)
    pv.add_argument("--model", required=True)
    pv.add_argument("--in-channels", type=int, default=1, choices=[1, 3])
    pv.add_argument("--stride", type=int, default=1)
    pv.add_argument("--max-leaves", type=int, default=100_000)
    _codec_options(pv)
    pv.add_argument("--report-dir", default=None,
                    help="also write PNG plots + report.md into this directory")
    pv.set_defaults(func=_cmd_eval)

    pg = sub.add_parser("datagen", help="Generate procedural npy leaf data.")
    pg.add_argument("out_dir")
    pg.add_argument("--volumes", type=int, default=8)
    pg.add_argument("--size", type=int, default=64)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--channels", type=int, default=1, choices=[1, 3])
    pg.add_argument("--family", default="smoke", choices=["smoke", "levelset", "mixed"],
                    help="scalar volume family: fog densities, narrow-band level "
                         "sets, or alternating")
    pg.set_defaults(func=_cmd_datagen)

    pe = sub.add_parser("encode", help="Compress grids to a .vqvdb file.")
    pe.add_argument("input", help=".vdb / .npy leaf file, or a directory of them")
    pe.add_argument("output", help="output .vqvdb path")
    pe.add_argument("--model", required=True, help=".vqmodel artifact")
    pe.add_argument("--grid", default=None, help="grid name filter")
    _codec_options(pe)
    pe.add_argument("--data-parallel", action="store_true",
                    help="shard each device step over all local devices")
    pe.add_argument("--streaming", action="store_true",
                    help="read a .vdb input lazily, O(batch) leaves in host memory; "
                         "the file is byte-identical to the default path's")
    _tier_options(pe)
    pe.add_argument("-v", "--verbose", action="store_true")
    pe.set_defaults(func=_cmd_encode)

    pd = sub.add_parser("decode", help="Decompress a .vqvdb file.")
    pd.add_argument("input", help=".vqvdb path")
    pd.add_argument("output", help="output directory for .npy grids, or a .vdb path")
    pd.add_argument("--model", required=True)
    _codec_options(pd)
    pd.add_argument("--grid", action="append", default=[],
                    help="decode only this grid (repeatable)")
    pd.add_argument("--bbox", help="voxel-space selection x0,y0,z0,x1,y1,z1 "
                                   "(lower inclusive, upper exclusive)")
    pd.add_argument("--dense", action="store_true",
                    help="write dense volumes over each grid's bounding box")
    pd.add_argument("--vdb", action="store_true",
                    help="write one OpenVDB .vdb file with all grids")
    pd.add_argument("--data-parallel", action="store_true",
                    help="shard each device step over all local devices")
    pd.add_argument("-v", "--verbose", action="store_true")
    pd.set_defaults(func=_cmd_decode)

    pi = sub.add_parser("info", help="Inspect a .vqvdb file.")
    pi.add_argument("input")
    pi.set_defaults(func=_cmd_info)

    pt = sub.add_parser("transcode", help="Rewrite a .vqvdb container without a model.")
    pt.add_argument("input")
    pt.add_argument("output")
    pt.add_argument("--format-version", type=int, default=None, choices=[3, 4, 5, 6],
                    help="target version (default: the source's)")
    pt.add_argument("--v5-codec", default="zlib", choices=["zlib", "lzma", "lz4"])
    pt.add_argument("--drop-residual", action="store_true",
                    help="confirm discarding a v6 residual stream")
    pt.add_argument("--grid", action="append", default=[],
                    help="keep only this grid (repeatable)")
    pt.set_defaults(func=_cmd_transcode)

    pes = sub.add_parser("encode-seq", help="Encode a sequence, one .vqvdb per frame.")
    pes.add_argument("input_dir")
    pes.add_argument("output_dir")
    pes.add_argument("--model", required=True)
    pes.add_argument("--glob", default="*.vdb", help="frame file pattern (*.vdb or *.npy)")
    pes.add_argument("--grid", default=None)
    pes.add_argument("--pattern", default="frame_{:04d}.vqvdb")
    _codec_options(pes)
    pes.add_argument("--data-parallel", action="store_true",
                     help="shard each device step over all local devices")
    _tier_options(pes, tol=False)
    pes.set_defaults(func=_cmd_encode_seq)

    pds = sub.add_parser("decode-seq", help="Decode a directory of per-frame .vqvdb files.")
    pds.add_argument("input_dir")
    pds.add_argument("output_dir")
    pds.add_argument("--model", required=True)
    pds.add_argument("--pattern", default="frame_*.vqvdb")
    pds.add_argument("--vdb", action="store_true", help="one .vdb per frame")
    _codec_options(pds)
    pds.add_argument("--data-parallel", action="store_true",
                     help="shard each device step over all local devices")
    pds.set_defaults(func=_cmd_decode_seq)

    pvi = sub.add_parser("vdbinfo", help="Inspect an OpenVDB .vdb file.")
    pvi.add_argument("input")
    pvi.set_defaults(func=_cmd_vdbinfo)

    pvf = sub.add_parser("verify", help="Verify a .vqvdb archive; with --against, its "
                                        "round trip against the source (exit 1 on a "
                                        "failed check).")
    pvf.add_argument("input", help=".vqvdb archive or a directory of them")
    pvf.add_argument("--against", default=None, help="source npy / .vdb file or directory")
    pvf.add_argument("--model", default=None, help="model artifact (with --against)")
    pvf.add_argument("--grid", default=None)
    _codec_options(pvf)
    pvf.set_defaults(func=_cmd_verify)

    pb = sub.add_parser("bench", help="Run the decode-throughput benchmark.")
    _device_option(pb)
    pb.set_defaults(func=_cmd_bench)

    pxv = sub.add_parser("extract", help="Extract .vdb leaves into npy files.")
    pxv.add_argument("inputs", nargs="+", help=".vdb files or directories")
    pxv.add_argument("out_dir")
    pxv.add_argument("--grid", default=None)
    pxv.set_defaults(func=_cmd_extract)

    ps = sub.add_parser("serve", help="Serve the codec over HTTP.")
    ps.add_argument("--model", required=True)
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8990, help="0 picks a free port")
    _codec_options(ps)
    ps.set_defaults(func=_cmd_serve)

    pm = sub.add_parser("import-torch",
                        help="Convert a reference torch .pth checkpoint to .vqmodel.")
    pm.add_argument("checkpoint")
    pm.add_argument("output")
    pm.add_argument("--in-channels", type=int, default=1, choices=[1, 3])
    pm.add_argument("--embedding-dim", type=int, default=128)
    pm.add_argument("--num-embeddings", type=int, default=256)
    _device_option(pm)
    pm.set_defaults(func=_cmd_import_torch)

    px = sub.add_parser("export-checkpoint",
                        help="Export a training checkpoint to a .vqmodel artifact.")
    px.add_argument("checkpoint_dir")
    px.add_argument("output")
    px.add_argument("--step", type=int, default=None, help="checkpoint step (default: latest)")
    px.add_argument("--best", action="store_true",
                    help="export the durable best-validation checkpoint")
    px.add_argument("--in-channels", type=int, default=1, choices=[1, 3])
    px.add_argument("--embedding-dim", type=int, default=128)
    px.add_argument("--num-embeddings", type=int, default=256)
    px.add_argument("--num-quantizers", type=int, default=1)
    px.add_argument("--encoder-arch", default="reference",
                    choices=["reference", "packed", "packed_lite", "packed_stem"],
                    help="encoder graph family")
    _device_option(px)
    px.set_defaults(func=_cmd_export_checkpoint)

    pxt = sub.add_parser("export-torch",
                         help="Export a .vqmodel to reference torch artifacts (.pth/.pt).")
    pxt.add_argument("model", help=".vqmodel artifact")
    pxt.add_argument("--checkpoint", help="output .pth (reference trainer layout)")
    pxt.add_argument("--torchscript", help="output .pt TorchScript (to_onnx.py-compatible)")
    _device_option(pxt)
    pxt.set_defaults(func=_cmd_export_torch)

    pxo = sub.add_parser("export-onnx",
                         help="Emit encoder.onnx/decoder.onnx for the reference ORT runtime.")
    pxo.add_argument("model", help=".vqmodel artifact")
    pxo.add_argument("output_dir", help="directory for encoder.onnx/decoder.onnx")
    pxo.add_argument("--no-validate", action="store_true",
                     help="skip the check of the graphs against the port's model")
    pxo.add_argument("--embed-header", default=None,
                     help="also write a bin_onnx.h-style C header embedding both models")
    _device_option(pxo)
    pxo.set_defaults(func=_cmd_export_onnx)
    return p


def main(argv=None) -> int:
    from vqvdb_tpu_torch.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    args = build_parser().parse_args(argv)
    try:
        if getattr(args, "data_parallel", False) and ":" in args.device:
            return _error("--data-parallel takes every local device: pass --device "
                          "cuda or cpu, without an index")
        return args.func(args)
    except BrokenPipeError:
        return 0
    except (VqvdbError, OSError) as e:
        # Malformed containers, model mismatches and bad artifacts are the
        # user's to fix, not crashes.
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
