"""Close the loop against the real PyTorch reference, the day it appears
(port of ``tools/close_the_loop.py``).

The reference the JAX package was rebuilt from has never been readable
here (SURVEY.md "Open items" 1-3): no tree, no network.  Given its source
tree this script, in order, emits one JSON report:

1. **Census**: with the tree absent or empty it says so, writes the stub
   report and exits 0 (so it can run unconditionally).
2. **Layout diff** (open item 1): the real tree against the layout SURVEY
   §1/§2 reconstructed (``dsnt/nn.py``, ``dsnt/model.py``, ...): what it
   predicted but the tree lacks, and what the tree has but it never mapped.
3. **Op parity** (open item 2): the reference's own ``dsnt()``, activation,
   ``make_gauss`` and regularizers against the **port's** torch ops
   (``dsnt_pose2d_tpu_torch.ops``) on shared fp64 fixtures, the largest
   deviation per op, and probes of the conventions SURVEY could only
   recall (grid endpoints, sigma units, gauss normalisation).
4. **Golden regeneration**: the op goldens rebuilt from the reference's
   module with the recipe of ``tests/oracle/torch_oracle.py`` (same seed,
   shapes and steps; the port keeps its own copy here), then the port's ops
   held against them in this process at the golden suite's tolerances
   (``tests/test_parity_goldens.py``).  The JAX suite is not run.
5. **Published-number re-pin** (open item 3): every PCKh-looking line of
   the reference's README/docs beside BASELINE.md's recalled numbers.

Security: the reference is public, untrusted content.  Steps 3-4 import
and run its code, which is their point, so its code is imported only when
this script runs, never as a side effect of importing the module; every
other step only reads files.

    python -m dsnt_pose2d_tpu_torch.tools.close_the_loop --reference <tree> \\
        [--out FILE.json] [--goldens-out FILE.npz] [--device cpu]

``--reference`` defaults to ``reference/`` at the repo's root (the JAX
tool's default is its image's mount point); the outputs default to the
temporary directory.  ``--device`` defaults to ``cuda`` and raises without
a card, as every driver's; the ops run on the CPU in fp64 whatever it says.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import sys
import tempfile
import traceback

from ..cli.common import add_device_arg
from ..device import resolve_device
from .ablation_common import REPO

# SURVEY §1/§2's reconstructed layout (matched by suffix).
SURVEY_LAYOUT = ["dsnt/nn.py", "dsnt/model.py", "dsnt/data.py", "dsnt/util.py",
                 "dsnt/eval.py", "train.py", "evaluate.py", "infer.py"]
OP_MODULE_CANDIDATES = ["dsnt.nn", "dsntnn", "nn"]
# BASELINE.md §6 recalled-not-verified numbers, for side-by-side re-pinning.
RECALLED_NUMBERS = {"hg8_dsnt_js_pckh_total": 87.2,
                    "hg1_dsnt_vs_heatmap_gap_at_16px": 6.0}
ORACLE_SEED = 20260816
# tests/test_parity_goldens.py's tolerances: (rtol, atol) per golden.
GOLDEN_TOL = {"heatmaps": (0, 1e-6), "pred_coords": (0, 1e-6),
              "gauss_rendered": (0, 1e-6), "euclidean": (0, 1e-6),
              "js": (1e-5, 1e-5), "kl": (1e-5, 1e-5), "mse_reg": (1e-5, 1e-5),
              "variance": (0, 1e-6), "total_loss": (0, 1e-6),
              "grad_raw": (0, 1e-6)}


def census(ref: str) -> dict:
    files = []
    for root, _dirs, names in os.walk(ref):
        files += [os.path.relpath(os.path.join(root, n), ref) for n in names]
    return {"n_files": len(files), "files": sorted(files)}


def layout_diff(files: list[str]) -> dict:
    found, missing = {}, []
    for want in SURVEY_LAYOUT:
        hits = [f for f in files if f.endswith(want)]
        if hits:
            found[want] = hits
        else:
            missing.append(want)
    unmapped = [f for f in files if f.endswith(".py") and "/test" not in f
                and not any(f.endswith(w) for w in SURVEY_LAYOUT)]
    return {"found": found, "survey_predicted_but_absent": missing,
            "present_but_unmapped_by_survey": unmapped}


def _import_reference_ops(ref: str):
    for extra in ("", "src", "lib"):
        p = os.path.join(ref, extra)
        if os.path.isdir(p) and p not in sys.path:
            sys.path.insert(0, p)
    for name in OP_MODULE_CANDIDATES:
        try:
            return importlib.import_module(name), name
        except Exception:
            continue
    return None, None


def op_parity(ref: str) -> dict:
    """The largest deviation of each reference op from the port's on fp64
    fixtures, and the convention probes."""
    import numpy as np
    import torch

    from .. import ops

    mod, name = _import_reference_ops(ref)
    if mod is None:
        return {"status": "reference op module not importable",
                "tried": OP_MODULE_CANDIDATES}
    rng = np.random.default_rng(0)
    b, j, h, w = 2, 16, 8, 8
    raw = torch.tensor(rng.normal(size=(b, j, h, w)))
    coords = torch.tensor(rng.uniform(-0.8, 0.8, size=(b, j, 2)))
    report: dict = {"module": name, "ops": {}, "probes": {}}

    def compare(op_name, ref_fn, ours):
        try:
            got = ref_fn()
            got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
            dev = float(np.max(np.abs(got - ours.detach().numpy())))
            report["ops"][op_name] = {"max_abs_dev": dev, "bit_parity": dev == 0.0}
        except Exception as e:
            report["ops"][op_name] = {"error": f"{type(e).__name__}: {e}"}

    hm = ops.flat_softmax(raw)
    if hasattr(mod, "flat_softmax"):
        compare("flat_softmax", lambda: mod.flat_softmax(raw), hm)
    if hasattr(mod, "dsnt"):
        compare("dsnt", lambda: mod.dsnt(hm), ops.dsnt(hm))
    if hasattr(mod, "make_gauss"):
        compare("make_gauss(sigma=1px)",   # positional: the kwarg's name is unpinned
                lambda: mod.make_gauss(coords, [h, w], 1.0),
                ops.make_gauss(coords, (h, w), 1.0))
    for reg, ours in [("kl_reg_loss", ops.kl_reg_losses),
                      ("js_reg_loss", ops.js_reg_losses),
                      ("mse_reg_loss", ops.mse_reg_losses)]:
        if hasattr(mod, reg):
            compare(reg, lambda reg=reg: getattr(mod, reg)(hm, coords, 1.0),
                    ours(hm, coords, 1.0))
    if hasattr(mod, "variance_reg_loss"):
        compare("variance_reg_loss", lambda: mod.variance_reg_loss(hm, 1.0),
                ops.variance_reg_losses(hm, 1.0))
    if hasattr(mod, "euclidean_loss"):
        compare("euclidean_loss", lambda: mod.euclidean_loss(coords + 0.01, coords),
                ops.average_loss(ops.euclidean_losses(coords + 0.01, coords)))
    try:
        if hasattr(mod, "dsnt"):
            delta = torch.zeros(1, 1, h, w, dtype=torch.float64)
            delta[0, 0, 0, 0] = 1.0    # the top-left pixel
            xy = mod.dsnt(delta).detach().numpy().ravel()
            first = float(ops.normalized_linspace(w, torch.float64)[0])
            report["probes"]["grid_convention"] = {
                "reference_dsnt(delta@0,0)": xy.tolist(),
                "ours_first_gridpoint": first,
                "pixel_center_formula_matches": bool(abs(xy[0] - first) < 1e-12)}
        if hasattr(mod, "make_gauss"):
            g = mod.make_gauss(torch.zeros(1, 1, 2, dtype=torch.float64),
                               [64, 64], 1.0).detach().numpy()
            report["probes"]["gauss"] = {
                "sum": float(g.sum()), "normalized_to_1": bool(abs(g.sum() - 1) < 1e-6),
                # sigma in pixels peaks near 0.16 on a 64-wide map; in
                # normalised units it would be ~32x wider.
                "peak": float(g.max()),
                "sigma_unit_guess": "pixels" if g.max() > 0.05 else "normalized"}
    except Exception:
        report["probes"]["error"] = traceback.format_exc(limit=2)
    return report


def golden_arrays(fns: dict) -> dict:
    """The goldens of ``tests/oracle/torch_oracle.py::generate_goldens``
    with each op taken from ``fns``."""
    import torch

    torch.manual_seed(ORACLE_SEED)
    raw = torch.randn(4, 16, 64, 64, dtype=torch.float32)
    coords = torch.rand(4, 16, 2, dtype=torch.float32) * 1.8 - 0.9
    mask = (torch.rand(4, 16) > 0.2).float()
    sigma = 1.0
    hm = fns["flat_softmax"](raw)
    pred = fns["dsnt"](hm)
    euc = fns["euclidean"](pred, coords)
    js = fns["js"](hm, coords, sigma)
    raw_g = raw.clone().requires_grad_(True)
    hm_g = fns["flat_softmax"](raw_g)
    loss = fns["avg"](fns["euclidean"](fns["dsnt"](hm_g), coords)
                      + fns["js"](hm_g, coords, sigma), mask)
    loss.backward()
    out = {"raw": raw, "target_coords": coords, "mask": mask,
           "sigma": torch.tensor(sigma), "heatmaps": hm, "pred_coords": pred,
           "euclidean": euc, "js": js, "kl": fns["kl"](hm, coords, sigma),
           "mse_reg": fns["mse"](hm, coords, sigma),
           "variance": fns["var"](hm, sigma),
           "total_loss": fns["avg"](euc + 1.0 * js, mask), "grad_raw": raw_g.grad,
           "gauss_rendered": fns["gauss"](coords, [64, 64], sigma)}
    return {k: v.detach().numpy() for k, v in out.items()}


def port_fns() -> dict:
    from .. import ops

    return {"flat_softmax": ops.flat_softmax, "dsnt": ops.dsnt,
            "euclidean": ops.euclidean_losses, "js": ops.js_reg_losses,
            "kl": ops.kl_reg_losses, "mse": ops.mse_reg_losses,
            "var": ops.variance_reg_losses,
            "gauss": lambda c, size, s: ops.make_gauss(c, tuple(size), s),
            "avg": ops.average_loss}


def hold_port_ops(goldens: dict) -> dict:
    """The port's ops on the goldens' inputs against the goldens."""
    import numpy as np

    ours = golden_arrays(port_fns())
    checks = {}
    for key, (rtol, atol) in GOLDEN_TOL.items():
        got, want = ours[key], np.asarray(goldens[key])
        dev = float(np.max(np.abs(got - want)))
        checks[key] = {"max_abs_dev": dev, "passed": bool(np.allclose(
            got, want, rtol=rtol, atol=atol))}
    return checks


def regen_goldens_and_hold(ref: str, goldens_out: str) -> dict:
    """Step 4: goldens from the reference's ops, the port's ops against them."""
    import numpy as np

    mod, name = _import_reference_ops(ref)
    if mod is None:
        return {"status": "reference op module not importable"}

    def resolve(*names):
        return next((getattr(mod, n) for n in names if hasattr(mod, n)), None)

    fns = {"flat_softmax": resolve("flat_softmax"), "dsnt": resolve("dsnt"),
           "euclidean": resolve("euclidean_losses", "euclidean_loss"),
           "js": resolve("js_reg_losses", "js_reg_loss"),
           "kl": resolve("kl_reg_losses", "kl_reg_loss"),
           "mse": resolve("mse_reg_losses", "mse_reg_loss"),
           "var": resolve("variance_reg_losses", "variance_reg_loss"),
           "gauss": resolve("make_gauss"), "avg": resolve("average_loss")}
    missing = sorted(k for k, v in fns.items() if v is None)
    if missing:
        return {"status": f"reference lacks resolvable ops: {missing}",
                "module": name}
    try:
        goldens = golden_arrays(fns)
        os.makedirs(os.path.dirname(goldens_out) or ".", exist_ok=True)
        np.savez(goldens_out, **goldens)
    except Exception:
        return {"status": "golden regeneration failed", "module": name,
                "error": traceback.format_exc(limit=3)}
    checks = hold_port_ops(goldens)
    return {"status": "ran", "module": name, "goldens": goldens_out,
            "port_ops": checks,
            "passed": all(c["passed"] for c in checks.values())}


def number_repin(ref: str, files: list[str]) -> dict:
    """Every PCKh-looking line of the reference's README/docs."""
    hits = []
    pat = re.compile(r"\b(\d{2}\.\d{1,2})\b")
    for f in files:
        if not f.lower().endswith((".md", ".rst", ".txt")):
            continue
        try:
            with open(os.path.join(ref, f), errors="replace") as fh:
                for i, line in enumerate(fh, 1):
                    if pat.search(line) and re.search(
                            r"pckh|accuracy|total|head|wrist|elbow", line, re.I):
                        hits.append({"file": f, "line": i,
                                     "text": line.strip()[:200]})
        except OSError:
            continue
    return {"recalled": RECALLED_NUMBERS, "candidate_lines": hits[:80]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference", default=os.path.join(REPO, "reference"))
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "reference_closure_report.json"))
    ap.add_argument("--goldens-out", default=os.path.join(
        tempfile.gettempdir(), "ops_goldens_reference.npz"))
    add_device_arg(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)

    report: dict = {"reference": args.reference}
    cen = census(args.reference) if os.path.isdir(args.reference) else {
        "n_files": 0, "files": []}
    report["census"] = {"n_files": cen["n_files"]}
    if cen["n_files"] == 0:
        report["status"] = ("mount empty — nothing to close; SURVEY open "
                            "items 1-3 remain blocked")
        print(json.dumps(report, indent=2))
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        return 0

    report["status"] = "mount populated — running closure"
    report["layout"] = layout_diff(cen["files"])
    report["op_parity"] = op_parity(args.reference)
    report["golden_regen"] = regen_goldens_and_hold(args.reference,
                                                    args.goldens_out)
    report["numbers"] = number_repin(args.reference, cen["files"])
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    bad = [k for k, v in report["op_parity"].get("ops", {}).items()
           if v.get("max_abs_dev", 0.0) > 1e-9 or "error" in v]
    regen = report["golden_regen"]
    red = regen.get("status") == "ran" and not regen["passed"]
    print(f"\n# closure: {cen['n_files']} files, "
          f"{len(report['layout']['survey_predicted_but_absent'])} layout gaps, "
          f"{len(bad)} ops off-parity, port ops on the reference's goldens "
          f"{'RED' if red else regen.get('status', '?')} -> {args.out}",
          file=sys.stderr)
    return 1 if (bad or red) else 0


if __name__ == "__main__":
    raise SystemExit(main())
