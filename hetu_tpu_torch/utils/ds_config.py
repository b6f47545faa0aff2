"""ds_parallel_config generators: the JSON parallel-layout IR (copy of
``hetu_tpu.utils.ds_config``; pure Python).

Counterpart of the reference's config generators
(``examples/gpt/ds_parallel_config/generate_gpt_3d_config.py`` and
``generate_gpt_hetero_3d_config.py``): given (dp, tp, pp[, hetero
layout]) over an ordered chip list, emit the per-module JSON spec
(``split``/``dup``/``device_group_union``/``type``/``zero``) parsed by
:func:`hetu_tpu_torch.nn.parallel.config2ds`.  Entries always use the union
form (one group per pipeline stage), which covers both the homogeneous
``device_group`` and heterogeneous ``device_group_union`` schemas of the
reference.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence


def _entry(split: Dict[str, List[int]], dup: List[int],
           groups: List[List[int]], kind: str = "variable",
           zero: bool = False) -> Dict:
    e = {"split": split, "dup": dup, "device_group_union": groups,
         "type": kind}
    if kind == "variable":
        e["zero"] = zero
    return e


def generate_gpt_3d_config(num_layers: int, dp: int, tp: int, pp: int,
                           num_devices: Optional[int] = None,
                           zero: bool = True,
                           devices: Optional[Sequence[int]] = None) -> Dict:
    """Homogeneous 3-D (dp x tp x pp) layout for a GPT stack.

    Layers are split evenly into pp stages; each stage occupies dp*tp
    chips (dp-major, tp-minor — the reference's device ordering).
    """
    n = num_devices or dp * tp * pp
    assert dp * tp * pp == n, f"dp*tp*pp != num_devices ({dp}*{tp}*{pp} != {n})"
    devices = list(devices) if devices is not None else list(range(n))
    per_stage = dp * tp
    stage_groups = [devices[s * per_stage:(s + 1) * per_stage]
                    for s in range(pp)]
    layers_per_stage = (num_layers + pp - 1) // pp

    cfg: Dict = {
        "zero": zero,
        "devices": devices,
        "input": _entry({"0": [dp]}, [tp], [stage_groups[0]],
                        kind="placeholder"),
        "gpt": {
            "wte": _entry({"0": [tp]}, [dp], [stage_groups[0]], zero=zero),
            "wpe": _entry({}, [per_stage], [stage_groups[0]], zero=zero),
            "blocks": {},
            "layernorm_final": _entry({}, [per_stage], [stage_groups[-1]],
                                      zero=zero),
        },
        "lm_head": _entry({"1": [tp]}, [dp], [stage_groups[-1]], zero=zero),
        "label": _entry({"0": [dp]}, [tp], [stage_groups[-1]],
                        kind="placeholder"),
    }
    blocks = cfg["gpt"]["blocks"]
    for s in range(pp):
        lo = s * layers_per_stage
        hi = min(num_layers - 1, (s + 1) * layers_per_stage - 1)
        if lo > hi:
            continue
        g = [stage_groups[s]]
        blocks[f"blocks{lo}-{hi}"] = {
            "range": [lo, hi],
            "layernorm1": _entry({}, [per_stage], g, zero=zero),
            "attn": {
                "qkv": _entry({"1": [tp]}, [dp], g, zero=zero),
                "dense": _entry({"0": [tp]}, [dp], g, zero=zero),
            },
            "layernorm2": _entry({}, [per_stage], g, zero=zero),
            "mlp": {
                "dense_h_to_4h": _entry({"1": [tp]}, [dp], g, zero=zero),
                "dense_4h_to_h": _entry({"0": [tp]}, [dp], g, zero=zero),
            },
        }
    return cfg


def generate_gpt_hetero_3d_config(num_layers: int,
                                  stage_layouts: Sequence[Dict],
                                  zero: bool = True) -> Dict:
    """Heterogeneous layout (Malleus): per-pipeline-stage dicts
    ``{"dp": int, "tp": int, "devices": [ids], "layers": [lo, hi]}`` with
    possibly unequal shapes per stage (reference
    generate_gpt_hetero_3d_config.py; hetero_stages in
    examples/gpt/train_hetu.py:256-335)."""
    devices: List[int] = []
    for st in stage_layouts:
        assert st["dp"] * st["tp"] == len(st["devices"]), \
            f"stage {st}: dp*tp != len(devices)"
        devices.extend(st["devices"])
    first, last = stage_layouts[0], stage_layouts[-1]

    def single(st, key_split, kind="variable"):
        g = [list(st["devices"])]
        if key_split == "col":
            split, dup = {"1": [st["tp"]]}, [st["dp"]]
        elif key_split == "row":
            split, dup = {"0": [st["tp"]]}, [st["dp"]]
        elif key_split == "vocab":
            split, dup = {"0": [st["tp"]]}, [st["dp"]]
        else:
            split, dup = {}, [len(st["devices"])]
        return _entry(split, dup, g, kind=kind,
                      zero=zero if kind == "variable" else False)

    cfg: Dict = {
        "zero": zero,
        "hetero": True,
        "devices": devices,
        "input": single(first, None, kind="placeholder"),
        "gpt": {
            "wte": single(first, "vocab"),
            "wpe": single(first, None),
            "blocks": {},
            "layernorm_final": single(last, None),
        },
        "lm_head": single(last, "col"),
        "label": single(last, None, kind="placeholder"),
    }
    blocks = cfg["gpt"]["blocks"]
    for st in stage_layouts:
        lo, hi = st["layers"]
        blocks[f"blocks{lo}-{hi}"] = {
            "range": [lo, hi],
            "layernorm1": single(st, None),
            "attn": {"qkv": single(st, "col"),
                     "dense": single(st, "row")},
            "layernorm2": single(st, None),
            "mlp": {"dense_h_to_4h": single(st, "col"),
                    "dense_4h_to_h": single(st, "row")},
        }
    return cfg


def save_ds_config(cfg: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)


def parse_layout(cfg: Dict):
    """Derive the (dp, tp, pp, zero) layout from a ds_parallel_config —
    the entry-path inverse of :func:`generate_gpt_3d_config` (reference
    reads the same fields in ``examples/gpt/train_hetu.py:256-335``).

    ``pp`` = number of distinct block device groups, in layer order
    (each stage's blocks share a DeviceGroupUnion).
    """
    first = cfg["input"]
    dp = first["split"].get("0", [1])[0]
    tp = first["dup"][0]
    seen: List[tuple] = []
    blocks = sorted(cfg["gpt"]["blocks"].items(),
                    key=lambda kv: kv[1].get("range", [0])[0])
    for _, block in blocks:
        grp = tuple(block["attn"]["qkv"]["device_group_union"][0])
        if grp not in seen:
            seen.append(grp)
    pp = max(1, len(seen))
    # "zero" is the reference-schema bool ds flag; planner-emitted configs
    # also carry "zero_stage" (0-3) — surface the strongest level found
    levels = [int(e.get("zero_stage", 1 if e.get("zero") else 0))
              for _, _, e in iter_block_entries(cfg)]
    zero = int(cfg.get("zero_stage", 1 if cfg.get("zero") else 0))
    zero = max([zero] + levels)
    return dp, tp, pp, zero


def parse_hetero_layout(cfg: Dict) -> List[Dict]:
    """Inverse of :func:`generate_gpt_hetero_3d_config`: recover the
    per-stage ``{"dp", "tp", "devices", "layers"}`` dicts from a hetero
    ds_parallel_config so the MPMD runtime can be built straight from the
    JSON (reference train_hetu.py:256-335 reads hetero configs the same
    way)."""
    stages: List[Dict] = []
    blocks = sorted(cfg["gpt"]["blocks"].items(),
                    key=lambda kv: kv[1].get("range", [0])[0])
    for _, block in blocks:
        qkv = block["attn"]["qkv"]
        devices = list(qkv["device_group_union"][0])
        tp = qkv["split"].get("1", [1])[0]
        dp = qkv["dup"][0]
        st = {"dp": dp, "tp": tp, "devices": devices,
              "layers": list(block["range"])}
        if stages and stages[-1]["devices"] == devices:
            stages[-1]["layers"][1] = st["layers"][1]
        else:
            stages.append(st)
    return stages


def iter_block_entries(cfg: Dict):
    """Yield (block_range, sub_name, entry) for every leaf block entry."""
    for bname, block in cfg["gpt"]["blocks"].items():
        for key, val in block.items():
            if key == "range":
                continue
            if "type" in val:
                yield block["range"], key, val
            else:
                for sub, leaf in val.items():
                    yield block["range"], f"{key}.{sub}", leaf
