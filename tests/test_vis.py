"""Visualization/export utilities."""

import json
import os

import numpy as np

from deepvcp.utils.vis import (
    draw,
    load_cloud_pairs,
    plot_metrics,
    save_cloud_pair,
    voxel_downsample,
    write_pcd,
)


class TestCloudIO:
    def test_save_load_roundtrip(self, tmp_path):
        rng = np.random.default_rng(0)
        gt = rng.standard_normal((50, 3)).astype(np.float32)
        pred = rng.standard_normal((50, 3)).astype(np.float32)
        save_cloud_pair(str(tmp_path), 0, gt, pred)
        save_cloud_pair(str(tmp_path), 1, gt + 1, pred + 1)
        pairs = load_cloud_pairs(str(tmp_path))
        assert len(pairs) == 2
        np.testing.assert_allclose(pairs[0][0], gt)
        np.testing.assert_allclose(pairs[0][1], pred)

    def test_write_pcd(self, tmp_path):
        pts = np.array([[0, 0, 0], [1, 2, 3]], np.float32)
        path = str(tmp_path / "out.pcd")
        write_pcd(path, pts, colors=np.array([[1, 0, 0], [0, 0, 1.0]]))
        text = open(path).read()
        assert "POINTS 2" in text and "DATA ascii" in text
        assert "FIELDS x y z rgb" in text

    def test_draw_without_open3d(self, tmp_path):
        rng = np.random.default_rng(1)
        out = str(tmp_path / "vis.pcd")
        draw([rng.standard_normal((30, 3)), rng.standard_normal((30, 3))], out)
        assert os.path.exists(out)


class TestVoxelDownsample:
    def test_reduces_and_centroids(self):
        pts = np.array(
            [[0.0, 0, 0], [0.01, 0, 0], [5, 5, 5]], np.float32
        )
        out = voxel_downsample(pts, 1.0)
        assert out.shape[0] == 2
        # centroid of the two near-origin points
        assert np.any(np.all(np.abs(out - [0.005, 0, 0]) < 1e-6, axis=1))


class TestPlotMetrics:
    def test_plot_from_jsonl(self, tmp_path):
        path = str(tmp_path / "metrics.jsonl")
        with open(path, "w") as fh:
            for i in range(25):
                fh.write(
                    json.dumps(
                        {"kind": "train", "loss": 1.0 / (i + 1),
                         "rre_deg": 0.5, "rte": 0.1}
                    )
                    + "\n"
                )
        out = plot_metrics(path, str(tmp_path / "loss.png"), smooth=5)
        assert os.path.exists(out)


class TestVoxelPlot:
    def test_plot_voxel_candidates(self, tmp_path):
        from deepvcp.utils.vis import plot_voxel_candidates

        rng = np.random.default_rng(0)
        kp = rng.uniform(-2, 2, (4, 3)).astype(np.float32)
        cand = kp[:, None, :] + rng.uniform(-1, 1, (4, 27, 3)).astype(
            np.float32
        )
        out = plot_voxel_candidates(kp, cand, str(tmp_path / "vox.png"))
        assert os.path.exists(out) and os.path.getsize(out) > 0
