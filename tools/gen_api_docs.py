"""Generate docs/API.md: one-line-per-symbol API reference.

Walks the package modules, collects public classes/functions with their
signatures and docstring summaries, and writes a grouped markdown
reference.  Run from the repo root after API changes:

    python tools/gen_api_docs.py
"""

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

MODULES = [
    "chargeflux_tpu.system",
    "chargeflux_tpu.energy",
    "chargeflux_tpu.charges",
    "chargeflux_tpu.pairs",
    "chargeflux_tpu.ewald",
    "chargeflux_tpu.pme",
    "chargeflux_tpu.cells",
    "chargeflux_tpu.neighbors",
    "chargeflux_tpu.topology",
    "chargeflux_tpu.bonded",
    "chargeflux_tpu.integrate",
    "chargeflux_tpu.nosehoover",
    "chargeflux_tpu.csvr",
    "chargeflux_tpu.constraints",
    "chargeflux_tpu.npt",
    "chargeflux_tpu.rbe",
    "chargeflux_tpu.units",
    "chargeflux_tpu.parallel.shard",
    "chargeflux_tpu.parallel.halo",
    "chargeflux_tpu.parallel.replicas",
    "chargeflux_tpu.parallel.multislice",
    "chargeflux_tpu.models.water",
    "chargeflux_tpu.models.salt",
    "chargeflux_tpu.models.solute",
    "chargeflux_tpu.models.onramp",
    "chargeflux_tpu.utils.checkpoint",
    "chargeflux_tpu.utils.trajectory",
    "chargeflux_tpu.utils.analysis",
    "chargeflux_tpu.utils.diagnose",
    "chargeflux_tpu.utils.profiling",
    "chargeflux_tpu.utils.compile_cache",
    "chargeflux_tpu.runtime.native",
]


def summary(obj) -> str:
    doc = inspect.getdoc(obj) or ""
    if not doc and hasattr(obj, "__wrapped__"):        # jit-wrapped API
        doc = inspect.getdoc(obj.__wrapped__) or ""
    first = doc.split("\n\n")[0].replace("\n", " ").strip()
    return first


def sig_of(obj) -> str:
    try:
        s = str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(…)"
    return s if len(s) <= 90 else s[:87] + "…)"


def main():
    out = ["# API reference", "",
           "Generated by `tools/gen_api_docs.py` — regenerate after API "
           "changes.  One line per public symbol; see docstrings for the "
           "full contracts and reference citations.", ""]
    for modname in MODULES:
        mod = importlib.import_module(modname)
        rows = []
        for name in sorted(vars(mod)):
            if name.startswith("_"):
                continue
            obj = vars(mod)[name]
            if inspect.ismodule(obj):
                continue
            # only symbols defined in (or jit-wrapped by) this module
            home = getattr(obj, "__module__", None)
            if home is not None and home != modname:
                # keep jit-wrapped functions re-exported intentionally
                if not (hasattr(obj, "__wrapped__") and getattr(
                        obj.__wrapped__, "__module__", None) == modname):
                    continue
            if inspect.isclass(obj):
                rows.append((name, "", f"**class** — {summary(obj)}"))
                for mname, m in sorted(vars(obj).items()):
                    if mname.startswith("_") or not callable(m):
                        continue
                    rows.append((f"{name}.{mname}", sig_of(m), summary(m)))
            elif callable(obj):
                rows.append((name, sig_of(obj), summary(obj)))
        if not rows:
            continue
        moddoc = summary(importlib.import_module(modname))
        out.append(f"## `{modname}`")
        out.append("")
        if moddoc:
            out.append(moddoc)
            out.append("")
        for name, sig, desc in rows:
            out.append(f"- **`{name}{sig}`** — {desc}")
        out.append("")
    path = os.path.join(os.path.dirname(__file__), "..", "docs", "API.md")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(out))
    print(f"wrote {os.path.abspath(path)} "
          f"({sum(1 for line in out if line.startswith('- '))} symbols)")


if __name__ == "__main__":
    main()
