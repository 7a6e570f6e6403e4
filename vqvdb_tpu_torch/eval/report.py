"""Visual evaluation report (counterpart of `vqvdb_tpu/eval/report.py`) —
the reference notebooks' plots as files. matplotlib is imported where a
plot is drawn; without it these functions raise its ImportError.

Renders the acceptance plots of notebook_scalar.ipynb / notebook_vec3f.ipynb
(per-block PSNR and MSE histograms, codebook usage histogram + dead codes,
mid-slice montage of original vs reconstruction vs |error|) into a directory
of PNGs plus a markdown summary, from the same evaluate_codec/codebook_report
data the CLI emits as JSON.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np


def write_report(
    out_dir: Union[str, Path],
    report: Dict,
    codebook: Dict,
    *,
    sample_leaves: Optional[np.ndarray] = None,
    sample_recon: Optional[np.ndarray] = None,
    title: str = "vqvdb_tpu_torch evaluation",
) -> Path:
    """Write PNG plots + report.md into out_dir; returns the md path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    # --- PSNR / MSE distributions (ref: notebook_scalar cells 2-4) -------
    psnr = report["per_block_psnr"]
    finite = psnr[np.isfinite(psnr)]
    fig, axes = plt.subplots(1, 2, figsize=(10, 3.5))
    axes[0].hist(finite, bins=60, color="#4878d0")
    axes[0].set(title="Per-block PSNR (dB)", xlabel="dB", ylabel="blocks")
    axes[1].hist(np.log10(np.maximum(report["per_block_mse"], 1e-12)),
                 bins=60, color="#ee854a")
    axes[1].set(title="Per-block log10(MSE)", xlabel="log10 MSE")
    fig.tight_layout()
    fig.savefig(out / "psnr_mse_hist.png", dpi=110)
    plt.close(fig)

    # --- Codebook usage (ref: notebook_vec3f usage/dead-code cells) ------
    counts = codebook["counts"]
    fig, ax = plt.subplots(figsize=(10, 3))
    order = np.argsort(counts)[::-1]
    ax.bar(np.arange(len(counts)), counts[order], width=1.0, color="#6acc64")
    ax.set(title=f"Codebook usage (sorted) — {codebook['active_codes']} active, "
                 f"{codebook['dead_codes']} dead, ppl {codebook['perplexity']:.1f}",
           xlabel="code (sorted by usage)", ylabel="assignments")
    fig.tight_layout()
    fig.savefig(out / "codebook_usage.png", dpi=110)
    plt.close(fig)

    # --- Mid-slice montage (ref: notebook_vec3f montage cells) -----------
    if sample_leaves is not None and sample_recon is not None:
        k = min(6, sample_leaves.shape[0])
        fig, axes = plt.subplots(3, k, figsize=(2.0 * k, 6))
        for i in range(k):
            orig = sample_leaves[i][..., 0]
            rec = sample_recon[i][..., 0]
            for row, (img, label) in enumerate(
                [(orig, "original"), (rec, "recon"),
                 (np.abs(orig - rec), "|error|")]):
                ax = axes[row, i] if k > 1 else axes[row]
                ax.imshow(img[:, :, img.shape[2] // 2], cmap="magma")
                ax.set_axis_off()
                if i == 0:
                    ax.set_title(label, loc="left", fontsize=9)
        fig.tight_layout()
        fig.savefig(out / "montage.png", dpi=110)
        plt.close(fig)

    # Residual-VQ embeddings carry S*K rows; use the caller's per-(stage,
    # code) counts when provided, and never color with a mismatched array.
    emb = codebook.get("embedding")
    pca_counts = codebook.get("pca_counts", counts)
    if emb is not None and pca_counts is not None \
            and len(pca_counts) != len(emb):
        pca_counts = None
    extra_pngs = write_latent_diagnostics(
        out,
        codebook_vectors=emb,
        counts=pca_counts,
        latents=report.get("latent_sample"),
        originals=sample_leaves,
        recons=sample_recon,
    )

    md = out / "report.md"
    lines = [
        f"# {title}",
        "",
        f"- blocks evaluated: **{report['num_blocks']}**",
        f"- MSE: **{report['mse']:.3e}**  (zero-voxel {report['zero_voxel_mse']:.3e}"
        f" / non-zero {report['nonzero_voxel_mse']:.3e})",
        f"- PSNR: mean **{report['psnr_mean']:.2f} dB**, p5 "
        f"{report['psnr_p5']:.2f}, median {report['psnr_p50']:.2f}",
        f"- codebook: {codebook['active_codes']} active / "
        f"{codebook['dead_codes']} dead, perplexity {codebook['perplexity']:.1f}",
        f"- eval basis: backend **{report.get('eval_backend', '?')}**, "
        f"compute dtype **{report.get('compute_dtype', '?')}** "
        "(bf16 and f32 evals of one artifact differ — compare like with like)",
        "",
        "![](psnr_mse_hist.png)",
        "![](codebook_usage.png)",
    ]
    if (out / "montage.png").exists():
        lines.append("![](montage.png)")
    lines.extend(f"![]({p})" for p in extra_pngs)
    md.write_text("\n".join(lines) + "\n")
    return md


def _pca2(x: np.ndarray) -> np.ndarray:
    """First two principal components of rows of x (SVD, centered)."""
    c = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(c, full_matrices=False)
    return c @ vt[:2].T


def _fast_ica2(x: np.ndarray, iters: int = 200, seed: int = 0) -> np.ndarray:
    """Two independent components of rows of x — symmetric FastICA with a
    tanh contrast (the reference notebook used sklearn's FastICA,
    notebook_scalar.ipynb cell 7; this is the same fixed-point iteration,
    self-contained in numpy)."""
    c = x - x.mean(axis=0, keepdims=True)
    # Whiten via PCA.
    u, s, vt = np.linalg.svd(c, full_matrices=False)
    k = min(8, s.size)  # whiten in a small subspace: enough for 2 ICs
    z = (u[:, :k] * np.sqrt(x.shape[0]))  # whitened rows (N, k)
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(2, k))

    def decorrelate(w):
        # W <- (W W^T)^{-1/2} W  (symmetric decorrelation)
        ew, ev = np.linalg.eigh(w @ w.T)
        return (ev * (1.0 / np.sqrt(np.maximum(ew, 1e-12)))) @ ev.T @ w

    w = decorrelate(w)
    for _ in range(iters):
        wx = z @ w.T                      # (N, 2)
        g = np.tanh(wx)
        g_prime = 1.0 - g * g
        w_new = (g.T @ z) / z.shape[0] - \
            (g_prime.mean(axis=0)[:, None] * w)
        w_new = decorrelate(w_new)
        if np.max(np.abs(np.abs(np.sum(w_new * w, axis=1)) - 1)) < 1e-6:
            w = w_new
            break
        w = w_new
    return z @ w.T


def write_latent_diagnostics(
    out: Path,
    *,
    codebook_vectors: Optional[np.ndarray] = None,
    counts: Optional[np.ndarray] = None,
    latents: Optional[np.ndarray] = None,
    originals: Optional[np.ndarray] = None,
    recons: Optional[np.ndarray] = None,
) -> list:
    """The reference analysis notebooks' deeper latent plots
    (notebook_scalar.ipynb cells 5-9): codebook PCA colored by usage,
    latent-space ICA, a log-binned |value| vs |error| heatmap, and the
    zero-vs-nonzero voxel error split. Each plot is emitted only when its
    inputs were provided; returns the PNG names written."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    written = []

    if codebook_vectors is not None:
        xy = _pca2(np.asarray(codebook_vectors, np.float64))
        fig, ax = plt.subplots(figsize=(5.5, 4.5))
        c = None if counts is None else np.log10(np.asarray(counts) + 1)
        sc = ax.scatter(xy[:, 0], xy[:, 1], c=c, s=14, cmap="viridis")
        if c is not None:
            fig.colorbar(sc, ax=ax, label="log10(1 + assignments)")
        ax.set(title="Codebook PCA (usage-colored)", xlabel="PC1",
               ylabel="PC2")
        fig.tight_layout()
        fig.savefig(out / "codebook_pca.png", dpi=110)
        plt.close(fig)
        written.append("codebook_pca.png")

    if latents is not None and latents.shape[0] >= 16:
        flat = np.asarray(latents, np.float64).reshape(-1,
                                                       latents.shape[-1])
        if flat.shape[0] > 20000:
            flat = flat[:: flat.shape[0] // 20000 + 1]
        ics = _fast_ica2(flat)
        fig, ax = plt.subplots(figsize=(5.5, 4.5))
        ax.scatter(ics[:, 0], ics[:, 1], s=3, alpha=0.25, color="#4878d0")
        ax.set(title=f"Latent ICA ({flat.shape[0]} latent vectors)",
               xlabel="IC1", ylabel="IC2")
        fig.tight_layout()
        fig.savefig(out / "latent_ica.png", dpi=110)
        plt.close(fig)
        written.append("latent_ica.png")

    if originals is not None and recons is not None:
        o = np.asarray(originals, np.float32).reshape(-1)
        e = np.abs(np.asarray(recons, np.float32).reshape(-1) - o)
        # Log-binned error heatmap (cell 8): |value| vs |error| density.
        lo_v = np.log10(np.abs(o) + 1e-8)
        lo_e = np.log10(e + 1e-10)
        fig, ax = plt.subplots(figsize=(5.5, 4.5))
        h = ax.hist2d(lo_v, lo_e, bins=80, cmap="magma",
                      norm=matplotlib.colors.LogNorm())
        fig.colorbar(h[3], ax=ax, label="voxels")
        ax.set(title="Error vs value (log-binned)",
               xlabel="log10 |value|", ylabel="log10 |error|")
        fig.tight_layout()
        fig.savefig(out / "error_heatmap.png", dpi=110)
        plt.close(fig)
        written.append("error_heatmap.png")

        # Zero-vs-nonzero split (cell 9) as distributions, not just means.
        zero = e[o == 0.0]
        nonz = e[o != 0.0]
        fig, ax = plt.subplots(figsize=(6.5, 3.5))
        bins = np.linspace(-10, max(float(lo_e.max()), -9.0), 70)
        for arr, label, color in ((zero, "zero voxels", "#4878d0"),
                                  (nonz, "non-zero voxels", "#ee854a")):
            if arr.size:
                ax.hist(np.log10(arr + 1e-10), bins=bins, alpha=0.6,
                        label=f"{label} (mse {np.mean(arr**2):.2e})",
                        color=color)
        ax.legend()
        ax.set(title="Per-voxel |error|, zero vs non-zero originals",
               xlabel="log10 |error|", ylabel="voxels")
        fig.tight_layout()
        fig.savefig(out / "zero_split.png", dpi=110)
        plt.close(fig)
        written.append("zero_split.png")

    return written
