"""Tables of the port's dry-run records (results/dryrun_torch/*.json): the
dry-run table and the roofline table on the H100's figures, the JAX
package's ``launch/report.py``.

The JAX package corrects its LM records for XLA counting a scanned
layer body once (``_lm_layer_correction``).  The port's counts cover
every layer already (the step is executed, not compiled), so
``corrected_terms`` corrects nothing: it reads the record's own terms
(``roofline.roofline_report``).  BFS rows read the level step.

    PYTHONPATH=src python -m repro_torch.launch.report > /tmp/tables.md
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.launch.roofline import roofline_report

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "dryrun_torch")


def corrected_terms(rec: Dict) -> Optional[Dict[str, float]]:
    """The roofline terms of a record (``roofline_report``: no scan
    correction, the counts hold every layer), with ``roofline_frac``,
    the compute term's share of the bound."""
    if rec.get("skipped"):
        return None
    r = roofline_report(rec)
    t = {k: r[k] for k in ("compute_s", "memory_s", "collective_s",
                           "model_flops")}
    t["dominant"] = r["dominant"] + "_s"
    t["useful_ratio"] = r["useful_ratio"] or 0.0
    t["bound_s"] = r["bound_time_s"]
    t["roofline_frac"] = (t["compute_s"] / t["bound_s"]) if t["bound_s"] \
        else 0.0
    return t


_NOTES = {
    ("lm", "memory"): "fuse the element-wise passes around the GEMMs "
                      "(norms, SwiGLU, casts) and keep activations bf16 to "
                      "cut HBM traffic",
    ("lm", "collective"): "overlap the expert all_to_alls with the expert "
                          "GEMMs over NVLink; ship bf16",
    ("lm", "compute"): "near roofline: only tensor-core (wgmma) occupancy "
                       "and TMA pipelining gains remain",
    ("gnn", "collective"): "the 2D expand/fold (launch/optimized.py) moves "
                           "(N/pc + N/pr) d words a device, not 2 N d",
    ("gnn", "memory"): "fuse gather and segment sum into one pass over "
                       "receiver-sorted edges, the row strip in shared "
                       "memory",
    ("gnn", "compute"): "dense MLP-bound: bf16 GEMMs on the tensor cores",
    ("recsys", "memory"): "embedding rows dominate: bf16 rows, one pass "
                          "of kernel 8 over the batch's distinct rows",
    ("recsys", "collective"): "ship ids over NVLink (all_to_all), not "
                              "dense row sums",
    ("recsys", "compute"): "attention over 39 fields is tiny; batch more",
    ("bfs", "collective"): "bitmap-compress the fold; overlap rotation "
                           "with local discovery",
    ("bfs", "memory"): "edge stream is HBM-bound: kernel 1's CSR walk "
                       "reads only the frontier's columns",
    ("bfs", "compute"): "BFS has no tensor-core work: memory/collective "
                        "only",
}


def load_all(results: str = RESULTS) -> Dict[str, Dict]:
    recs = {}
    for f in sorted(glob.glob(os.path.join(results, "*.json"))):
        with open(f) as fh:
            recs[os.path.basename(f)[:-5]] = json.load(fh)
    return recs


def dryrun_table(recs) -> str:
    rows = ["| cell | mesh | trace s | args GiB/dev | temps GiB/dev | "
            "collectives (count) | flops/dev |",
            "|---|---|---|---|---|---|---|"]
    gib = 1 << 30
    for tag, r in recs.items():
        if r.get("skipped"):
            rows.append(f"| {tag} | - | - | - | - | SKIPPED: "
                        f"{r['reason'][:60]} | - |")
            continue
        mem = r.get("memory", {})
        args = mem.get("argument_size_in_bytes", 0) / gib
        temps = mem.get("temp_size_in_bytes", 0) / gib
        c = r.get("collectives", {})
        counts = ", ".join(f"{k.replace('count_', '')}:{int(v)}"
                           for k, v in sorted(c.items())
                           if k.startswith("count_"))
        rows.append(
            f"| {r['cell']} | {r['mesh']} | {r.get('trace_s', 0)} | "
            f"{args:.2f} | {temps:.2f} | {counts or '-'} | "
            f"{r.get('flops', 0):.3g} |")
    return "\n".join(rows)


def roofline_table(recs) -> str:
    rows = ["| cell | compute s | memory s | collective s | bound | "
            "MODEL_FLOPS | useful ratio | what would move the bound |",
            "|---|---|---|---|---|---|---|---|"]
    for tag, r in recs.items():
        if not tag.endswith("__sp") or r.get("skipped"):
            continue
        use = r.get("level_step", r)
        t = corrected_terms(use)
        if t is None:
            continue
        fam = use.get("meta", {}).get("family", "?")
        dom = t["dominant"].replace("_s", "")
        note = _NOTES.get((fam, dom), "")
        rows.append(
            f"| {r['cell']} | {t['compute_s']:.3e} | {t['memory_s']:.3e} | "
            f"{t['collective_s']:.3e} | {dom} | {t['model_flops']:.3g} | "
            f"{t['useful_ratio']:.3f} | {note} |")
    return "\n".join(rows)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", default=RESULTS)
    args = ap.parse_args(argv)
    recs = load_all(args.results)
    n_ok = sum(1 for r in recs.values() if not r.get("skipped"))
    n_skip = sum(1 for r in recs.values() if r.get("skipped"))
    print(f"## Dry-run ({n_ok} traced cells, {n_skip} documented skips)\n")
    print(dryrun_table(recs))
    print("\n## Roofline (single-pod 16x16, H100 figures, counts of every "
          "layer)\n")
    print(roofline_table(recs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
