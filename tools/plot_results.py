"""Figure generation from the results/*.jsonl bench artifacts.

The reference renders its benchmark sweeps offline with MATLAB
(`cusadi/run_benchmarks.py:91-96` saves `.mat`; `cusadi/plotting/*.m`
makes the figures). Here the same role reads the machine-readable
artifacts `bench_common.make_emitter` writes and renders PNG figures
into results/plots/:

  sweep.png              units/s vs batch per method  (bench_sweep.jsonl)
  headline_history.png   bench.py headline over runs  (bench.jsonl)
  training.png           on-device ARS learning curve (train_rl_mpc_tpu.jsonl)

Plot only rows measured on the device you mean to show: every run's header
row names the device it ran on.

Only figures whose artifact exists are produced; reruns overwrite.
Usage: python tools/plot_results.py [--results-dir results]
"""

from __future__ import annotations

import argparse
import json
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

# Fixed-order categorical palette (validated default from the dataviz
# reference instance; hues follow the entity — a method keeps its color
# across figures and filtered reruns).
SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300"]
TEXT = "#333333"
GRID = "#dddddd"


def _read(path):
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    return rows


def _style(ax, xlabel, ylabel, title):
    ax.set_xlabel(xlabel, color=TEXT)
    ax.set_ylabel(ylabel, color=TEXT)
    ax.set_title(title, color=TEXT, loc="left")
    ax.grid(True, color=GRID, linewidth=0.6, zorder=0)
    ax.set_axisbelow(True)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(GRID)
    ax.tick_params(colors=TEXT)


def plot_sweep(rows, out):
    recs = [r for r in rows if "method" in r and "solve_units_per_sec" in r]
    if not recs:
        return False
    # Latest record per (method, workload, horizon, batch): reruns
    # supersede. One LINE per (method, workload, horizon) — merging
    # incomparable measurement conditions into one method line would
    # zigzag across workloads/horizons.
    latest = {}
    for r in recs:
        latest[(r["method"], r.get("workload", ""),
                r.get("horizon", 10), r["batch"])] = r
    series_keys = sorted({k[:3] for k in latest})
    # Color follows the METHOD (the entity); condition varies linestyle.
    methods = sorted({m for m, _, _ in series_keys})
    styles = ["-", "--", ":", "-."]
    conds = sorted({(w, h) for _, w, h in series_keys})
    fig, ax = plt.subplots(figsize=(7.5, 4.5), dpi=150)
    for (m, w, h) in series_keys:
        pts = sorted(
            (k[3], v["solve_units_per_sec"])
            for k, v in latest.items() if k[:3] == (m, w, h)
        )
        if not pts:
            continue
        xs, ys = zip(*pts)
        c = SERIES[methods.index(m) % len(SERIES)]
        ls = styles[conds.index((w, h)) % len(styles)]
        cond = ", ".join(x for x in (w, f"T={h}" if h != 10 else "") if x)
        label = f"{m} ({cond})" if cond else m
        ax.plot(xs, ys, ls, marker="o", color=c, linewidth=2,
                markersize=5, label=label, zorder=3)
        if len(pts) >= 2:  # direct-label lines; lone points legend-only
            ax.annotate(label, (xs[-1], ys[-1]), xytext=(6, 0),
                        textcoords="offset points", color=TEXT,
                        fontsize=8, va="center")
    ax.set_xscale("log", base=2)
    _style(ax, "batch size", "5-iteration solve units / s",
           "Batched MPC solve throughput by method")
    if len(series_keys) >= 2:
        ax.legend(frameon=False, fontsize=7, labelcolor=TEXT,
                  loc="lower right")
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return True


def plot_headline(rows, out):
    recs = [r for r in rows if r.get("metric", "").startswith("qp_solves")]
    if not recs:
        return False
    fig, ax = plt.subplots(figsize=(6, 3.6), dpi=150)
    xs = range(1, len(recs) + 1)
    ys = [r["value"] / 1e3 for r in recs]
    ax.plot(xs, ys, "-o", color=SERIES[0], linewidth=2, markersize=5,
            zorder=3)
    for x, y, r in zip(xs, ys, recs):
        ax.annotate(r["extra"].get("solver", ""), (x, y), xytext=(0, 8),
                    textcoords="offset points", ha="center", color=TEXT,
                    fontsize=7)
    ax.set_xticks(list(xs))
    _style(ax, "recorded run", "k solves / s",
           "bench.py headline across recorded runs")
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return True


def plot_training(rows, out):
    """On-device ARS training: learning curve per batch size with
    the measured env-steps/s in the labels (train_rl_mpc_tpu.jsonl)."""
    runs = []  # (num_envs, mass_error, matrix?, [(iter, ret)], rate)
    cur, cur_mass, cur_mat = [], 1.0, False
    for r in rows:
        if "iter" in r and "mean_return" in r:
            cur.append((r["iter"], r["mean_return"]))
        elif "summary" in r:
            sm = r["summary"]
            runs.append((sm["num_envs"], cur_mass, cur_mat, cur,
                         sm.get("env_steps_per_s")))
            # Reset accumulators at the run boundary so iter rows whose
            # header was trimmed away don't inherit this run's labels.
            cur, cur_mass, cur_mat = [], 1.0, False
        elif "run" in r:
            cur = []
            cur_mass = r.get("params", {}).get("mass_error", 1.0)
            cur_mat = bool(r.get("params", {}).get("matrix_residual"))
    if not runs:
        return False
    fig, ax = plt.subplots(figsize=(6, 4), dpi=150)
    for i, (envs, mass, matrix, pts, rate) in enumerate(runs):
        if not pts:
            continue
        xs, ys = zip(*sorted(pts))
        label = f"{envs} envs"
        if mass and mass != 1.0:
            label += f", plant mass x{mass}"
        if matrix:
            label += ", matrix residuals"
        if rate:
            label += f" ({rate / 1e3:.0f}k env-steps/s)"
        ax.plot(xs, ys, "-o", color=SERIES[i % len(SERIES)], linewidth=2,
                markersize=5, label=label, zorder=3)
    ax.xaxis.get_major_locator().set_params(integer=True)
    _style(ax, "ARS iteration", "mean return (40-step rollout)",
           "On-device RL-MPC training (one dispatch per iteration)")
    ax.legend(frameon=False, fontsize=8, labelcolor=TEXT,
              loc="lower right")
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--results-dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "results"))
    args = ap.parse_args()
    d = args.results_dir
    plots = os.path.join(d, "plots")
    os.makedirs(plots, exist_ok=True)
    made = []
    for name, fn, src in (
        ("sweep.png", plot_sweep, "bench_sweep.jsonl"),
        ("headline_history.png", plot_headline, "bench.jsonl"),
        ("training.png", plot_training, "train_rl_mpc_tpu.jsonl"),
    ):
        if fn(_read(os.path.join(d, src)), os.path.join(plots, name)):
            made.append(name)
    print(f"wrote {len(made)} figure(s) to {plots}: {', '.join(made)}")


if __name__ == "__main__":
    main()
