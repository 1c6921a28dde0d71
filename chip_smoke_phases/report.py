"""The ``kernels`` line of ``chip_smoke.py``: every kernel's numbers from the
phases' results."""
from __future__ import annotations


from chip_smoke_phases.common import GEMMA, GEMMA_RUNS, WHISPER


def kernels(out: dict) -> list:
    """The ``kernels`` line's entries: every kernel of the port with its
    launches on each path, its error against its plain version, its
    times and bound, from the results of phases 3-17 (``Run.out``)."""
    errs, rows = out[3]["errs"], out[3]["rows"]
    f_errs, f_rows = out[3]["f_errs"], out[3]["f_rows"]
    b_worst, b_err, b_rows = (out[3]["b_worst"], out[3]["b_err"],
                              out[3]["b_rows"])
    w_rows = out[3]["w_rows"]
    lse_errs, lse_rows = out[3]["lse_errs"], out[3]["lse_rows"]
    small_launches = out[4]["small_launches"]
    launches = out[5]["launches"]
    f_launches = out[6]["f_launches"]
    t_launches, ssm_train = out[7]["t_launches"], out[7]["ssm_train"]
    m_errs, m_rows = out[8]["m_errs"], out[8]["m_rows"]
    e_launches = out[9]["e_launches"]
    c_launches = out[10]["c_launches"]
    families = out[12]["families"]
    examples, ex_launches, long_rows = (out[13]["examples"],
                                        out[13]["ex_launches"],
                                        out[13]["long_rows"])
    sh = out[14]["sh"]
    sharded_train = out[15]["sharded_train"]
    sharded_serve = out[16]["sharded_serve"]
    sharded_families = out[17]["sharded_families"]
    ssm_cell = out[17]["ssm_cell"]
    csrc = "src/repro_torch/kernels/csrc/"
    main_shape = {"gqa": ("qwen3-moe-235b-a22b", 1024, 4),
                  "mla": ("minicpm3-4b", 1024, 4)}
    kernels = []
    for kind, name, replaces in (
            ("gqa", "paged_decode_attention",
             "src/repro/kernels/paged_attention.py:121"),
            ("mla", "paged_mla_decode_attention",
             "src/repro/kernels/paged_attention.py:225")):
        geom, ctx, B = main_shape[kind]
        row = next(r for r in rows if r["case"] == geom
                   and r["ctx"] == ctx and r["B"] == B
                   and r["dtype"] == "bfloat16")
        kernels.append({
            "name": name, "route": "cuda",
            "source": csrc + "paged_attention.cu",
            "replaces": replaces, "launches": launches[name],
            "launches_elastic": e_launches[name],
            "launches_cache": c_launches[name],
            "launches_examples": ex_launches[name],
            "max_abs_err": errs[kind], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": row["library"],
            "max_row_rms_bf16": errs[f"{kind}_row_rms"],
            "shape": f"{geom} B={B} context {ctx} bf16"})
        # phase 13a's long-context call of this kernel
        lc = examples["long_context"]
        long_row = long_rows["row1" if kind == "gqa" else "row2"]
        kernels[-1]["long_context"] = dict(
            {k: long_row[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "library")},
            max_abs_err=lc["row1_max_abs_err" if kind == "gqa"
                           else "row2_max_abs_err"],
            launches=lc["launches_row1" if kind == "gqa"
                        else "launches_row2"])
        # the float32 body at the same geometry (16 KiB f32 pages), both
        # contexts, and the float32 decode step of phase 4 that runs it
        kernels[-1]["f32"] = dict(
            rows=[{k: r[k] for k in ("ctx", "B", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "library")}
                  for r in rows if r["case"] == geom
                  and r["dtype"] == "float32"],
            max_abs_err=errs[f"{kind}_float32"],
            launches_small=small_launches[name])
    for name, source, replaces, shape in (
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:29",
             "zamba2 B=1 S=1024 bf16"),
            ("decode_attention", "paged_attention.cu",
             "src/repro/kernels/paged_attention.py:35",
             "zamba2 B=4 T=1024 bf16"),
            ("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:27",
             "zamba2 H=64 P=64 N=64 S=1024 chunk 256 bf16")):
        row = next(r for r in f_rows if r["kernel"] == name
                   and r["shape"] == shape)
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": replaces, "launches": f_launches[name],
            "launches_examples": ex_launches[name],
            "max_abs_err": f_errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": row.get("library"), "shape": shape})
        if name in ("flash_attention", "decode_attention"):
            # phase 14a's runs, unsharded and sharded
            part = "prefill" if name == "flash_attention" else "decode"
            kernels[-1]["launches_sharding"] = {
                "unsharded": sh[f"launches_{part}_unsharded"][name],
                "sharded": sh[f"launches_{part}"][name]}
            # phase 16's runs: one rank, then each of the four ranks
            kernels[-1]["launches_sharded_serve"] = {
                run["label"]: {
                    "one rank": run["one_rank"][f"launches_{part}"][name],
                    "four ranks": [r[f"launches_{part}"][name]
                                   for r in run["ranks"]]}
                for run in sharded_serve["runs"]}
            kernels[-1]["local_heads"] = [
                dict(r, max_abs_err=sharded_serve["kernel_errs"][name])
                for r in sharded_serve["kernel_rows"]
                if r["kernel"] == name]
            # the float32 body: the ranks' geometries and the float32
            # serve runs' launches at one rank
            kernels[-1]["f32"] = dict(
                rows=[r for r in sharded_serve["kernel_rows"]
                      + sharded_families["kernel_rows"]
                      if r["kernel"] == name
                      and r["shape"].endswith("float32")],
                launches={run["label"]:
                          run["one_rank"][f"launches_{part}"][name]
                          for run in sharded_serve["runs"]
                          if "float32" in run["label"]})
        # phase 17's runs: each arch and dtype at one rank (the Model
        # path, the cell), then each of the four ranks; and the ranks'
        # geometries
        part = "decode" if name == "decode_attention" else "prefill"
        kernels[-1]["launches_sharded_families"] = {
            **{f"17a {key}": {"model path": one[f"launches_{part}"][name],
                              "cell": one["cell"][f"launches_{part}"][name]}
               for key, one in sharded_families["one_rank"].items()},
            **{run["label"]: [r[f"launches_{part}"][name]
                              for r in run["ranks"]]
               for run in sharded_families["runs"]}}
        kernels[-1]["rank_heads"] = [
            dict(r, max_abs_err=sharded_families["kernel_errs"][name])
            for r in sharded_families["kernel_rows"] if r["kernel"] == name]
        if name == "decode_attention":
            # the log-sum-exp output: phase 3's check and a 16b rank's
            # slice timed; its launches on every rank of each run that
            # splits the cache's sequence (phases 16-17)
            row = lse_rows[0]
            kernels[-1]["lse"] = dict(
                {k: row[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms", "library")},
                max_abs_err=lse_errs["lse"], max_abs_err_out=lse_errs["out"],
                rows=lse_rows, launches={
                    run["label"]: [r["launches_decode"]["decode_attention_lse"]
                                   for r in run["ranks"]]
                    for run in sharded_serve["runs"]
                    + sharded_families["runs"]
                    if run["ranks"][0]["seq_split"]})
        if name in families["kernel_errs"]:
            # phase 12's shapes at head dim 256 and its launches
            g, w = families["gemma3"], families["whisper"]
            kernels[-1]["head_dim_256"] = [
                dict(shape=r["shape"], ms=r["ms"], plain_ms=r["plain_ms"],
                     bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                     library_ms=r["library_ms"], library=r["library"],
                     max_abs_err=families["kernel_errs"][name])
                for r in families["kernel_rows"] if r["kernel"] == name]
            kernels[-1]["launches_families"] = {
                f"{GEMMA} {label} {part}": g[label][f"launches_{part}"][name]
                for label, *_ in GEMMA_RUNS
                for part in ("prefill", "decode")}
            kernels[-1]["launches_families"].update({
                f"{WHISPER} {part}": w[f"launches_{part}"][name]
                for part in ("prefill", "decode")})
        if name == "ssd_scan":
            # phases 7b-7d: the train path's forwards, timed in float32
            kernels[-1]["train_rows"] = [
                r for r in f_rows if r["kernel"] == name
                and r["shape"].endswith("(train shape)")]
            kernels[-1]["launches_train"] = {
                **{f"7b-7c {m}": t["launches"][name]
                   for m, t in ssm_train.items()},
                "7d cell": ssm_cell["launches"][name]}
    # row 6b: the SSD scan's backward, at the train path's shape
    row = b_rows[0]
    kernels.append({
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": csrc + "ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_chunked.py:41 (jax.vjp of the "
                    "XLA route's chunked form, the reference's training "
                    "path; the Pallas _ssd_kernel at ssd_scan.py:27 has no "
                    "backward)",
        "launches": sum(t["launches"]["ssd_scan_bwd"]
                        for t in ssm_train.values()),
        "launches_train": {
            **{f"7b-7c {m}": t["launches"]["ssd_scan_bwd"]
               for m, t in ssm_train.items()},
            "7d cell": ssm_cell["launches"]["ssd_scan_bwd"]},
        "max_abs_err": b_err, "max_err_over_scale": b_worst,
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "library": None, "shape": row["shape"],
        "rows": b_rows})
    w_row = next(r for r in w_rows if r["shape"] == "qwen3-moe decode B=4")
    kernels.append({
        "name": "paged_kv_write", "route": "cuda",
        "source": csrc + "kv_write.cu",
        "replaces": "src/repro/kernels/ops.py:79 (an XLA scatter, no "
                    "Pallas kernel)",
        "launches": launches["paged_kv_write"],
        "launches_elastic": e_launches["paged_kv_write"],
        "launches_cache": c_launches["paged_kv_write"],
        "launches_examples": ex_launches["paged_kv_write"],
        "max_abs_err": 0.0,
        "ms": w_row["ms"], "plain_ms": w_row["plain_ms"],
        "bound_ms": w_row["bound_ms"], "bound_by": w_row["bound_by"],
        "library_ms": None, "library": None,
        "shape": "qwen3-moe decode B=4 rows of 2 x 4 x 128 bf16"})
    train_shape = next(r["shape"] for r in m_rows
                       if r["dtype"] == "float32")
    for name in ("moe_gemm", "moe_gemm_wgrad"):       # wgrad: its gradient
        row = next(r for r in m_rows if r["kernel"] == name
                   and r["shape"] == train_shape
                   and r["load"] == "gate/up layer 0")
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + "moe_gemm.cu",
            "replaces": "src/repro/kernels/moe_gemm.py:23",
            "launches": t_launches[name],
            "launches_examples": ex_launches[name],
            "launches_sharded_train": {
                f"{run['one_rank']['label']} {part}": counts
                for run in sharded_train["runs"]
                for part, counts in (
                    ("one rank", run["one_rank"]["launches"][name]),
                    ("four ranks", [r["launches"][name] for r in
                                    run["four_ranks"]["ranks"]]))},
            "max_abs_err": m_errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": "torch._grouped_mm" if row["library_ms"] else None,
            "shape": train_shape})
        if name == "moe_gemm_wgrad":
            sk = next(r for r in m_rows if r["kernel"] == name
                      and r["shape"] == train_shape
                      and r["load"] == "gate/up skewed load")
            kernels[-1]["skewed_load"] = {k: sk[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    return kernels
