"""The port's public names against the JAX package's, read with ``ast``.

Every ``src/repro/**.py`` has its port file under ``src/repro_torch/``
(two files were renamed, ``RENAMES``), and every public name of the
reference file (a module-level ``def``, ``class`` or assignment, or a
class's method, no part of it starting with ``_``) is defined in the port
file or imported there, unless ``ALLOWED`` says where the port's
counterpart lives or why none can exist.  Each ``ALLOWED`` entry must
still be absent from the port and present in the reference, so the list
cannot go stale.  Nothing of either package is imported.
"""
import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

#: reference file -> its port file, where the names differ
RENAMES = {"analysis/jaxpr_audit.py": "analysis/graph_audit.py",
           "launch/hlo_analysis.py": "launch/op_analysis.py"}

_HLO = ("HLO-text parser: the port counts a step's ops on meta in "
        "launch/op_analysis.py (analyze_step, analyze_fused_step)")
_NEG_INF = "the Pallas kernel's mask constant: the CUDA kernels keep theirs"

#: "reference file:name" -> where the port's counterpart lives, or why
#: none can exist
ALLOWED = {
    "analysis/jaxpr_audit.py:audit_closure":
        "a jaxpr walk: the port audits a fused body in "
        "analysis/graph_audit.py (audit_fused_step)",
    "analysis/jaxpr_audit.py:audit_hlo":
        "an HLO-text audit: analysis/graph_audit.py audits the body's "
        "recorded calls and allocations",
    "analysis/jaxpr_audit.py:flat_param_index":
        "jaxpr parameter positions: the port's audit reads storages",
    "launch/hlo_analysis.py:Computation": _HLO,
    "launch/hlo_analysis.py:analyze": _HLO,
    "launch/hlo_analysis.py:depth_trips_for": _HLO,
    "launch/hlo_analysis.py:donated_params": _HLO,
    "launch/hlo_analysis.py:entry_output_shapes": _HLO,
    "launch/hlo_analysis.py:host_transfer_count": _HLO,
    "launch/hlo_analysis.py:input_output_aliases": _HLO,
    "launch/hlo_analysis.py:parse_module": _HLO,
    "launch/hlo_analysis.py:while_trip_structure": _HLO,
    "launch/hlo_analysis.py:xla_cost_analysis": _HLO,
    "launch/roofline.py:collective_bytes":
        "HLO collectives: the port counts the collectives' bytes on meta "
        "(launch/mesh.py Mesh.counted)",
    "kernels/ops.py:set_default_impl":
        "the port routes each call by its tensors' device",
    "kernels/ops.py:get_default_impl":
        "the port routes each call by its tensors' device",
    "kernels/ops.py:donate_argnums":
        "jit donation: the port updates buffers in place",
    "kernels/flash_attention.py:NEG_INF": _NEG_INF,
    "kernels/paged_attention.py:NEG_INF": _NEG_INF,
    "sharding/spec.py:named":
        "a jax NamedSharding builder: the port places leaves by "
        "shard_shape / local slices",
    "sharding/spec.py:RuleSet.tree_shardings":
        "a tree of jax NamedShardings: RuleSet.spec_for per leaf",
    "sharding/strategies.py:CONSTRAIN":
        "the jax.lax.with_sharding_constraint alias: the port's hooks "
        "place their collectives explicitly",
    "sharding/strategies.py:Strategy.params_shardings":
        "NamedShardings: the port's is Strategy.param_specs",
    "sharding/strategies.py:Strategy.cache_shardings":
        "NamedShardings: the port's is Strategy.step_cache_rules",
    "launch/dryrun.py:SDS": "the jax.ShapeDtypeStruct alias: meta tensors",
    "models/hooks.py:Array": "the jax.Array alias: torch.Tensor",
    "models/moe.py:make_moe_a2a":
        "moved to sharding/moe_a2a.py (make_moe_a2a)",
    "launch/mesh.py:ICI_BW":
        "the TPU's ICI rate: the port's link rate is NVLINK_BW",
}


def _targets(node):
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _targets(elt)


def public_names(path: pathlib.Path, imports: bool = False) -> set:
    """The public names ``path`` defines (and, with ``imports``, those its
    module-level imports bind): module-level functions, classes and
    assignments, and ``Class.method``, no part starting with ``_``."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{sub.name}" for sub in node.body
                           if isinstance(sub, (ast.FunctionDef,
                                               ast.AsyncFunctionDef)))
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                out.update(_targets(target))
        elif isinstance(node, ast.AnnAssign):
            out.update(_targets(node.target))
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return {n for n in out
            if not any(part.startswith("_") for part in n.split("."))}


def port_file(rel: str) -> pathlib.Path:
    return PORT / RENAMES.get(rel, rel)


REF_FILES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", REF_FILES)
def test_port_file_holds_the_reference_names(rel):
    """The port file exists and defines or imports every public name of
    the reference file that ``ALLOWED`` does not list."""
    port = port_file(rel)
    assert port.is_file(), f"{rel} has no port file {port.relative_to(SRC)}"
    missing = sorted(n for n in public_names(REF / rel)
                     - public_names(port, imports=True)
                     if f"{rel}:{n}" not in ALLOWED)
    assert not missing, f"{port.relative_to(SRC)} lacks {missing}"


@pytest.mark.parametrize("entry", sorted(ALLOWED))
def test_allowed_entry_is_still_a_gap(entry):
    """An allowed name is still public in the reference and still absent
    from the port file."""
    rel, name = entry.split(":")
    assert name in public_names(REF / rel), f"{entry}: gone from the reference"
    assert name not in public_names(port_file(rel), imports=True), \
        f"{entry}: the port has it now; take it out of ALLOWED"


def test_renames_name_files_of_both_packages():
    for ref, port in RENAMES.items():
        assert (REF / ref).is_file() and (PORT / port).is_file()
        assert not (PORT / ref).exists()
