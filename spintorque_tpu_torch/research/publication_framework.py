"""Statistics, figures, and report assembly for research results.

PyTorch counterpart of ``spintorque_tpu/research/publication_framework.py``:
markdown/LaTeX tables, matplotlib figures and a reproducibility manifest
from experiment results, with Holm-Bonferroni-corrected significance and
effect sizes. The statistics are numpy/scipy, value for value the JAX
module's. The manifest records python, torch, CUDA and the card's name and
power limit in place of the JAX version, backend and devices. matplotlib is
imported only where a figure is drawn, so the rest runs where it is not
installed.
"""

from __future__ import annotations

import json
import platform
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .benchmarking import bootstrap_ci, significance_test

__all__ = ["StatisticalAnalyzer", "FigureGenerator", "PublicationFramework"]


class StatisticalAnalyzer:
    """Descriptive + inferential statistics over named sample groups."""

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha

    @staticmethod
    def describe(samples: Sequence[float]) -> Dict[str, float]:
        xs = np.asarray(samples, float)
        lo, hi = bootstrap_ci(xs) if xs.size > 1 else (float(xs[0]), float(xs[0]))
        return {
            "n": int(xs.size),
            "mean": float(xs.mean()),
            "std": float(xs.std(ddof=1)) if xs.size > 1 else 0.0,
            "median": float(np.median(xs)),
            "min": float(xs.min()),
            "max": float(xs.max()),
            "ci95_low": lo,
            "ci95_high": hi,
        }

    def compare_groups(
        self, groups: Dict[str, Sequence[float]]
    ) -> Dict[str, Any]:
        """All-pairs Welch tests with Holm-Bonferroni correction."""
        names = list(groups)
        pairs: List[Tuple[str, str, Dict[str, float]]] = []
        for i, a in enumerate(names):
            for b in names[i + 1 :]:
                pairs.append((a, b, significance_test(groups[a], groups[b])))
        m = len(pairs)
        ranked = sorted(range(m), key=lambda i: pairs[i][2]["p_value"])
        significant = set()
        for rank, idx in enumerate(ranked):
            if pairs[idx][2]["p_value"] <= self.alpha / (m - rank):
                significant.add(idx)
            else:
                break
        return {
            "descriptives": {n: self.describe(groups[n]) for n in names},
            "pairwise": [
                {
                    "a": a,
                    "b": b,
                    **stats,
                    "significant_after_correction": i in significant,
                }
                for i, (a, b, stats) in enumerate(pairs)
            ],
            "alpha": self.alpha,
        }

    @staticmethod
    def to_markdown_table(descriptives: Dict[str, Dict[str, float]]) -> str:
        header = "| method | n | mean | std | 95% CI |\n|---|---|---|---|---|"
        rows = [
            f"| {name} | {d['n']} | {d['mean']:.4g} | {d['std']:.3g} | "
            f"[{d['ci95_low']:.4g}, {d['ci95_high']:.4g}] |"
            for name, d in descriptives.items()
        ]
        return "\n".join([header] + rows)

    @staticmethod
    def to_latex_table(descriptives: Dict[str, Dict[str, float]],
                       caption: str = "Results") -> str:
        rows = "\n".join(
            f"    {name} & {d['n']} & {d['mean']:.4g} & {d['std']:.3g} & "
            f"[{d['ci95_low']:.4g}, {d['ci95_high']:.4g}] \\\\"
            for name, d in descriptives.items()
        )
        return (
            "\\begin{table}[t]\n\\centering\n"
            "\\begin{tabular}{lcccc}\n\\toprule\n"
            "    Method & $n$ & Mean & Std & 95\\% CI \\\\\n\\midrule\n"
            f"{rows}\n\\bottomrule\n\\end{{tabular}}\n"
            f"\\caption{{{caption}}}\n\\end{{table}}"
        )


class FigureGenerator:
    """Matplotlib figure factory (Agg backend; files only, no display)."""

    def __init__(self, output_dir: str | Path = "figures", dpi: int = 150):
        self.output_dir = Path(output_dir)
        self.dpi = dpi

    def _save(self, fig, name: str) -> str:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        path = self.output_dir / f"{name}.png"
        fig.savefig(path, dpi=self.dpi, bbox_inches="tight")
        import matplotlib.pyplot as plt

        plt.close(fig)
        return str(path)

    def comparison_bars(
        self, groups: Dict[str, Sequence[float]], name: str = "comparison",
        ylabel: str = "value",
    ) -> str:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        names = list(groups)
        means = [np.mean(groups[n]) for n in names]
        errs = []
        for n in names:
            lo, hi = bootstrap_ci(np.asarray(groups[n], float))
            errs.append((np.mean(groups[n]) - lo, hi - np.mean(groups[n])))
        errs = np.asarray(errs).T
        ax.bar(names, means, yerr=errs, capsize=4)
        ax.set_ylabel(ylabel)
        ax.grid(axis="y", alpha=0.3)
        return self._save(fig, name)

    def convergence_curves(
        self, curves: Dict[str, Sequence[float]], name: str = "convergence",
        xlabel: str = "iteration", ylabel: str = "objective", logy: bool = False,
    ) -> str:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        for label, ys in curves.items():
            ax.plot(np.asarray(ys, float), label=label)
        if logy:
            ax.set_yscale("log")
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.legend()
        ax.grid(alpha=0.3)
        return self._save(fig, name)

    def error_suppression(
        self, physical_rates: Sequence[float], logical_rates: Sequence[float],
        name: str = "suppression",
    ) -> str:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(5, 4))
        ax.loglog(physical_rates, physical_rates, "--", label="unencoded")
        ax.loglog(physical_rates, logical_rates, "o-", label="d=3 surface code")
        ax.set_xlabel("physical error rate")
        ax.set_ylabel("logical error rate")
        ax.legend()
        ax.grid(which="both", alpha=0.3)
        return self._save(fig, name)


class PublicationFramework:
    """Assemble analysis + figures + manifest into a publication bundle."""

    def __init__(self, output_dir: str | Path = "publication", alpha: float = 0.05):
        self.output_dir = Path(output_dir)
        self.analyzer = StatisticalAnalyzer(alpha)
        self.figures = FigureGenerator(self.output_dir / "figures")
        self._sections: List[Tuple[str, str]] = []
        self._experiments: Dict[str, Dict[str, Sequence[float]]] = {}

    def add_experiment(
        self, name: str, groups: Dict[str, Sequence[float]]
    ) -> Dict[str, Any]:
        """Register named sample groups; returns the statistical analysis."""
        self._experiments[name] = groups
        analysis = self.analyzer.compare_groups(groups)
        table = self.analyzer.to_markdown_table(analysis["descriptives"])
        fig_path = self.figures.comparison_bars(groups, name=f"{name}_bars")
        body = (
            f"{table}\n\n"
            f"![{name}]({Path(fig_path).relative_to(self.output_dir)})\n\n"
            + "\n".join(
                f"- {p['a']} vs {p['b']}: p={p['p_value']:.3g}, "
                f"d={p['cohens_d']:.2f}"
                + (" (significant)" if p["significant_after_correction"] else "")
                for p in analysis["pairwise"]
            )
        )
        self._sections.append((name, body))
        return analysis

    @staticmethod
    def reproducibility_manifest(extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        import torch

        from ..utils.host import card_line

        cuda = torch.cuda.is_available()
        manifest = {
            "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
            "platform": platform.platform(),
            "python": platform.python_version(),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "card": card_line() if cuda else None,
            "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                        if cuda else ["cpu"]),
        }
        if extra:
            manifest.update(extra)
        return manifest

    def generate_report(self, title: str = "Results") -> str:
        """Write report.md + manifest.json; returns the report path."""
        self.output_dir.mkdir(parents=True, exist_ok=True)
        manifest = self.reproducibility_manifest()
        lines = [f"# {title}", ""]
        for name, body in self._sections:
            lines += [f"## {name}", "", body, ""]
        lines += [
            "## Reproducibility",
            "",
            "```json",
            json.dumps(manifest, indent=2),
            "```",
        ]
        report = self.output_dir / "report.md"
        report.write_text("\n".join(lines))
        (self.output_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
        return str(report)
