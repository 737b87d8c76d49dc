"""Error/confidence correlation workflow over a run directory
(counterpart of ``skelsplat_tpu/tools/analyze_confidence.py``).

The reference script consumes an ``info_confidences_*.json`` artifact whose
producer it never ships; this module closes the loop on a run directory:

* ``build_info(run_dir, cfg_dataset)`` — the missing producer: walks the
  run's ``point_cloud/iteration_*/{scene}.ply`` results, reconstructs each
  joint's 3D covariance from the optimized Gaussian parameters, joins the
  dataset's GT poses, and emits the reference's JSON schema (one record
  per scene with per-joint ``3d_pred``/``3d_gt``/``covariance``/``error``/
  ``joint_errors``/``anisotropy``/``trace``/``eigenvalues``,
  analize_error_confidence_correlation.py:64-83, 117-137).
* ``analyze(info, out_dir)`` — the reference's statistics and plots:
  overall and per-joint k-sigma GT coverage (…:38-60, 86-113), the
  error-vs-trace scatter pair (…:162-179, saved as PNGs instead of
  plt.show), plus Pearson correlations for the two scatters.

CLI:  python -m skelsplat_tpu_torch.tools.analyze_confidence <run_dir> \
          --data-root <dataset> [--initial-guess triangulation] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from skelsplat_tpu_torch import analysis
from skelsplat_tpu_torch.data.loader import DataLoader
from skelsplat_tpu_torch.evaluation import _scene_plys

# analize_error_confidence_correlation.py:193 — the H36M joint order
H36M_JOINT_NAMES = [
    "root", "lhip", "lknee", "lfoot", "rhip", "rknee", "rfoot", "spine",
    "thorax", "neck", "head", "rshoulder", "relbow", "rhand", "lshoulder",
    "lelbow", "lhand"]


def joint_names_for(n_joints: int):
    if n_joints == len(H36M_JOINT_NAMES):
        return list(H36M_JOINT_NAMES)
    return [f"j{i}" for i in range(n_joints)]


def build_info(run_dir: str, loader: DataLoader) -> list[dict]:
    """The info-JSON producer (see module docstring). Returns the
    reference-schema list; scenes without a PLY in the run are skipped."""
    plys = _scene_plys(run_dir)
    names = joint_names_for(loader.n_joints)
    records = []
    for _, rec in loader:
        path = plys.get(rec.scene_name)
        if path is None:
            continue
        means, covs, _scales = analysis.gaussian_cov_from_ply(path)
        gt = np.asarray(rec.pose_3d_gt, np.float64)
        joint_errors = np.linalg.norm(means - gt, axis=1)
        eigvals = np.linalg.eigvalsh(covs)                  # (J,3) ascending
        info = {}
        for j, name in enumerate(names):
            info[name] = {
                "3d_pred": means[j].tolist(),
                "3d_gt": gt[j].tolist(),
                "covariance": covs[j].tolist(),
                "error": float(joint_errors[j]),
                "joint_errors": joint_errors.tolist(),
                "anisotropy": float(eigvals[j, -1]
                                    / max(eigvals[j, 0], 1e-12)),
                "trace": float(np.trace(covs[j])),
                "eigenvalues": eigvals[j].tolist(),
            }
        records.append({"scene": rec.scene_name, "info": info})
    return records


def get_means_covs_gt(info):
    """analize_error_confidence_correlation.py:64-83 — flatten the info
    records to (N·J, 3) means / (N·J, 3, 3) covs / (N·J, 3) gt. Accepts a
    path or the loaded list."""
    if isinstance(info, (str, os.PathLike)):
        with open(info) as f:
            info = json.load(f)
    means, covs, gt = [], [], []
    for scene in info:
        for joint in scene["info"]:
            d = scene["info"][joint]
            means.append(d["3d_pred"])
            covs.append(d["covariance"])
            gt.append(d["3d_gt"])
    return np.array(means), np.array(covs), np.array(gt)


def analyze(info, out_dir: str | None = None, n_joints: int | None = None,
            print_fn=print) -> dict:
    """The reference's analysis pass over an info JSON (…:117-199):
    k-sigma coverage (overall + per joint), error-vs-trace statistics,
    and — when ``out_dir`` is given — the scatter/bar plots as PNGs."""
    if isinstance(info, (str, os.PathLike)):
        with open(info) as f:
            info = json.load(f)
    means, covs, gt = get_means_covs_gt(info)
    if n_joints is None:
        n_joints = len(info[0]["info"]) if info else 0
    names = joint_names_for(n_joints)

    coverage = analysis.percent_inside_sigmas(means, covs, gt)
    per_joint = analysis.percent_inside_sigmas_per_joint(
        means.reshape(-1, n_joints, 3), covs.reshape(-1, n_joints, 3, 3),
        gt.reshape(-1, n_joints, 3), names)

    # the scatter quantities (…:129-146)
    errors, joint_errors, traces = [], [], []
    for scene in info:
        for joint in scene["info"]:
            d = scene["info"][joint]
            errors.append(d["error"])
            joint_errors.append(d["joint_errors"])
            traces.append(d["trace"])
    errors = np.asarray(errors, np.float64)
    traces = np.asarray(traces, np.float64)
    j_errors = np.mean(np.asarray(joint_errors, np.float64), axis=1)

    def corr(a, b):
        if a.size > 1 and a.std() > 0 and b.std() > 0:
            return float(np.corrcoef(a, b)[0, 1])
        return float("nan")

    result = {
        "coverage": coverage,
        "coverage_per_joint": per_joint,
        "corr_error_trace": corr(traces, errors),
        "corr_scene_error_trace": corr(traces, j_errors),
        "n_scenes": len(info),
    }
    print_fn(f"Percent inside sigmas: {coverage}")
    print_fn(f"Percent inside sigmas for all joints: {per_joint}")
    print_fn(f"corr(error, trace)={result['corr_error_trace']:.4f}  "
             f"corr(scene_error, trace)={result['corr_scene_error_trace']:.4f}")

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        # the reference's two scatters (…:162-179)
        fig = plt.figure(figsize=(12, 6))
        plt.subplot(1, 2, 1)
        plt.scatter(traces, errors, alpha=0.5)
        plt.title("Error vs Trace")
        plt.xlabel("Trace")
        plt.ylabel("Error")
        plt.subplot(1, 2, 2)
        plt.scatter(traces, j_errors, alpha=0.5)
        plt.title("Joints Error vs Trace")
        plt.xlabel("Trace")
        plt.ylabel("Joints Error")
        plt.tight_layout()
        fig.savefig(os.path.join(out_dir, "error_vs_trace.png"), dpi=120)
        plt.close(fig)

        # the per-joint k-sigma bar chart (…:7-34)
        ks = (1, 2, 3)
        x = np.arange(len(names))
        fig, ax = plt.subplots(figsize=(14, 6))
        colors = ["#66c2a5", "#fc8d62", "#8da0cb"]
        for i, k in enumerate(ks):
            ax.bar(x + i * 0.25, [per_joint[n][k] * 100 for n in names],
                   width=0.25, label=f"{k}σ", color=colors[i])
        ax.set_xticks(x + 0.25)
        ax.set_xticklabels(names, rotation=45, ha="right")
        ax.set_ylabel("Percentage of GT joints")
        ax.set_ylim(0, 105)
        ax.set_title("Percent of GT inside k-sigma")
        ax.legend()
        ax.grid(True, linestyle="--", alpha=0.4)
        plt.tight_layout()
        fig.savefig(os.path.join(out_dir, "sigma_coverage.png"), dpi=120)
        plt.close(fig)
        result["plots"] = ["error_vs_trace.png", "sigma_coverage.png"]
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", help="training run dir (holds point_cloud/)")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--initial-guess", default="triangulation")
    ap.add_argument("--poses-2d", default="gt")
    ap.add_argument("--frame-step", type=int, default=64)
    ap.add_argument("--start-id", type=int, default=0)
    ap.add_argument("--end-id", type=int, default=2181)
    ap.add_argument("--nviews", type=int, default=4)
    ap.add_argument("--out", default=None,
                    help="output dir for the JSON + plots "
                         "(default <run_dir>/confidence_analysis)")
    args = ap.parse_args(argv)

    loader = DataLoader(
        args.data_root,
        os.path.join(args.data_root, "initial_guess", args.initial_guess),
        os.path.join(args.data_root, "2d_" + args.poses_2d),
        frame_step=args.frame_step, start_id=args.start_id,
        end_id=args.end_id, nviews=args.nviews)

    out_dir = args.out or os.path.join(args.run_dir, "confidence_analysis")
    os.makedirs(out_dir, exist_ok=True)
    info = build_info(args.run_dir, loader)
    if not info:
        sys.exit(f"no result PLYs under {args.run_dir}/point_cloud")
    info_path = os.path.join(out_dir, "info_confidences.json")
    with open(info_path, "w") as f:
        json.dump(info, f)
    print(f"wrote {info_path} ({len(info)} scenes)")
    analyze(info, out_dir=out_dir, n_joints=loader.n_joints)


if __name__ == "__main__":
    main()
