#!/usr/bin/env python
"""Generate benchmarks/textured_eval.json: guide-aware vs guide-blind
ablations of CVF / WMF / FGS on both synthetic surface models.

The plain synthetic scenes'
textures are smoothed noise, so the guide image carries no usable edge
structure and guide-aware stages measured WORSE than guide-blind
ablations — the offline evidence could not support the claims made for
three shipped features.  The "textured" surface model
(io/synthetic.py::patterned_texture: per-surface base intensities,
smooth interiors) is the regime those stages are built for; this script
runs both surface models through stm-eval with each stage's guide
DISABLED-in-place for the blind ablation:

  * CVF blind: --cvf-eps 1e6  (a -> 0, b -> mean_p: plain double-box)
  * WMF blind: --wmf-sigma 1e6 (every affinity ~1: plain 5x5 median)
  * FGS blind: --fgs-sigma 1e6 (uniform Laplacian smoothing)

FGS is judged on RMSE (it is a float smoother/inpainter — it trades
integer bad-pixel for surface quality by design); CVF/WMF on bad-pixel.

Usage: python tools/make_textured_eval.py [--out benchmarks/textured_eval.json]
"""

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent

CONFIGS = ("census:wta,census:wta:sgm,census:wta:cvf,ssd:wta:cvf,"
           "census:wta:sgm+wmf,census:wta:sgm+fgs")


def run_eval(texture, blind, tmp):
    out = tmp / f"{texture}_{'blind' if blind else 'aware'}.json"
    cmd = [sys.executable, "-m", "stereomatch_tpu.cli.evaluate",
           "--synthetic", "8", "--synthetic-texture", texture,
           "--configs", CONFIGS, "--cvf-radius", "4",
           "--fgs-lambda", "1", "--device", "cpu",
           "--json", str(out)]
    if blind:
        cmd += ["--cvf-eps", "1e6", "--wmf-sigma", "1e6",
                "--fgs-sigma", "1e6"]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=3600, cwd=REPO)
    if proc.returncode != 0:
        raise RuntimeError(f"stm-eval failed:\n{proc.stderr[-2000:]}")
    return json.loads(out.read_text())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(REPO / "benchmarks"
                                         / "textured_eval.json"))
    args = ap.parse_args()

    results = {}
    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        for texture in ("noise", "textured"):
            for blind in (False, True):
                key = f"{texture}_{'blind' if blind else 'aware'}"
                rows = run_eval(texture, blind, tmp)
                results[key] = {r["name"]: {
                    "rmse": round(r["rmse"], 4),
                    "bad_pixel_pct": round(100 * r["bad_pixel_ratio"], 3),
                } for r in rows}
                print(key, json.dumps(results[key], indent=1))

    # The claims this artifact exists to support, asserted so a
    # regression fails loudly at regeneration time.
    t_aware, t_blind = results["textured_aware"], results["textured_blind"]
    claims = {
        "cvf_guided_beats_blind_on_textured":
            t_aware["census-wta-cvf"]["bad_pixel_pct"]
            < t_blind["census-wta-cvf"]["bad_pixel_pct"],
        "wmf_guided_beats_blind_on_textured":
            t_aware["census-wta-sgm-wmf"]["bad_pixel_pct"]
            < t_blind["census-wta-sgm-wmf"]["bad_pixel_pct"],
        "fgs_guided_beats_blind_on_textured_rmse":
            t_aware["census-wta-sgm-fgs"]["rmse"]
            < t_blind["census-wta-sgm-fgs"]["rmse"],
    }
    payload = {"configs": CONFIGS, "results": results, "claims": claims}
    pathlib.Path(args.out).write_text(json.dumps(payload, indent=1))
    print(json.dumps(claims, indent=1))
    if not all(claims.values()):
        print("CLAIM REGRESSION — see above", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
