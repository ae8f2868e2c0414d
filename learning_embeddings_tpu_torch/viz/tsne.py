"""t-SNE feature plots: the port of ``learning_embeddings_tpu/viz/tsne.py``
(the same code; sklearn's ``TSNE`` and matplotlib are imported inside
``render_tsne``, so the module imports on a machine with neither).
Counterpart of `network/viz_tsne.py` (:15-104): 3-D t-SNE of penultimate
features, one figure per taxonomy level, multi-angle PNGs and, with
``animate=True``, a rotating GIF per level (matplotlib's PillowWriter)."""

from __future__ import annotations

import os

import numpy as np

__all__ = ["render_tsne"]


def render_tsne(features: np.ndarray, level_labels: np.ndarray, labelmap,
                out_dir: str, n_components: int = 3,
                angles=(0, 60, 120), max_points: int = 2000,
                animate: bool = False, n_frames: int = 36,
                fps: int = 10) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    if n_components != 3:
        # the renderer is 3-D (the reference's viz_tsne is, viz_tsne.py:
        # 15-104); accepting other values would crash on emb[:, 2] below
        raise ValueError("render_tsne renders 3-D projections only")
    os.makedirs(out_dir, exist_ok=True)
    n = min(len(features), max_points)
    if n < 2:
        return      # nothing to embed; sklearn requires >= 2 samples
    # sklearn requires perplexity < n_samples — clamp the 5..30 window
    # down for tiny debug/toy feature sets
    perplexity = min(min(30, max(5, n // 10)), n - 1)
    emb = TSNE(n_components=n_components, init="pca",
               perplexity=perplexity,
               random_state=0).fit_transform(features[:n])
    for l in range(labelmap.n_levels):
        labels = level_labels[:n, l]
        fig = plt.figure(figsize=(5 * len(angles), 5))
        for j, az in enumerate(angles):
            ax = fig.add_subplot(1, len(angles), j + 1, projection="3d")
            sc = ax.scatter(emb[:, 0], emb[:, 1], emb[:, 2], c=labels,
                            cmap="tab20", s=6, alpha=0.8)
            ax.view_init(elev=20, azim=az)
            ax.set_title(f"level {l} az={az}")
        fig.savefig(os.path.join(out_dir, f"tsne_level{l}.png"),
                    bbox_inches="tight", dpi=110)
        plt.close(fig)
        if animate:
            # rotating-view animation (reference viz_tsne.py mp4; GIF here)
            from matplotlib import animation

            fig = plt.figure(figsize=(5, 5))
            ax = fig.add_subplot(projection="3d")
            ax.scatter(emb[:, 0], emb[:, 1], emb[:, 2], c=labels,
                       cmap="tab20", s=6, alpha=0.8)
            ax.set_title(f"level {l}")

            def turn(frame, ax=ax):
                ax.view_init(elev=20, azim=frame * 360.0 / n_frames)
                return ()

            anim = animation.FuncAnimation(fig, turn, frames=n_frames,
                                           blit=False)
            anim.save(os.path.join(out_dir, f"tsne_level{l}.gif"),
                      writer=animation.PillowWriter(fps=fps))
            plt.close(fig)
