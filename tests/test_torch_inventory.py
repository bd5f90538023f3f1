"""The port is complete against the JAX package, as a tier-1 fact.

Read as text (``ast``; this file imports neither jax nor torch):

- every top-level function, class, method and UPPER_CASE constant of
  every module of ``gs_slam_analytica_jacobian_tpu/`` (dunders left out)
  is defined in the port's module at the same path (``ops/pallas/X.py``
  -> ``ops/X.py``) under its own name, or is listed in ``ELSEWHERE``
  (and defined where it says), or in ``NOT_PORTED`` with its reason. A
  new name on the JAX side needs a port counterpart or a line here;
- the lists stay honest: their keys still exist in the JAX sources, and
  no ``NOT_PORTED`` name is defined in the port module it maps to;
- every ``pl.pallas_call(`` site of the JAX package and ``scripts/`` is
  a key of the port's ``ops/launches.py`` ``PALLAS_SITES``, and no key is
  stale; each names CUDA sources that exist and ``COUNTERS`` names.
  Every CUDA source in ``csrc/`` is a site's or one of
  ``OTHER_SOURCES``, the kernels that replace no site, and the sites'
  counters and ``OTHER_SOURCES``' together cover ``COUNTERS`` exactly.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "gs_slam_analytica_jacobian_tpu"
PORT_PKG = ROOT / "gs_slam_analytica_jacobian_tpu_torch"
LAUNCHES = PORT_PKG / "ops" / "launches.py"

# JAX names the port defines in another module, under the name given
ELSEWHERE = {
    "ops.renderer_tiled.CHUNK": "ops.tile_kernel2.K",
    "ops.renderer_tiled.TILE_W": "ops.tile_kernel2.TPX",
    "ops.renderer_tiled.TILE_H": "ops.tile_kernel2.TPY",
    "ops.renderer_tiled._grid_dims": "ops.tile_kernel2.grid_dims",
}

_TPU_LAYOUT = ("TPU block layout (ROADMAP, queue B's kernel-wide rules): "
               "the CUDA kernels keep the per-pixel semantics, not this")
_PALLAS_SITE = ("a pl.pallas_call site: its CUDA kernels and wrappers are "
                "in ops/launches.py PALLAS_SITES")
_CUSTOM_VJP = ("jax.custom_vjp internals: the port's wrapper is a "
               "torch.autograd.Function")
_CHUNK_STATS = ("reads the TPU kernel's spare output channel 5 "
                "(tile_kernel2.py:362-366) for scripts/profile_kernels.py, "
                "a TPU tool not to port (ROADMAP)")
_PREWARMED = ("shape families whose XLA compiles were walked ahead; the "
              "port has no compiles: prewarm only builds the CUDA kernels")

NOT_PORTED = {
    "ops.pair_gather._fwd_impl": _CUSTOM_VJP,
    "ops.pair_gather._pg_fwd": _CUSTOM_VJP,
    "ops.pair_gather._pg_bwd": _CUSTOM_VJP,
    "ops.pallas.tile_kernel2._c32_fwd": _CUSTOM_VJP,
    "ops.pallas.tile_kernel2._c32_bwd": _CUSTOM_VJP,
    "ops.pallas.tile_kernel16._c16_fwd": _CUSTOM_VJP,
    "ops.pallas.tile_kernel16._c16_bwd": _CUSTOM_VJP,
    "ops.pallas.tile_kernel2._fwd_impl": _PALLAS_SITE,
    "ops.pallas.tile_kernel2._bwd_impl": _PALLAS_SITE,
    "ops.pallas.tile_kernel16._fwd_impl16": _PALLAS_SITE,
    "ops.pallas.tile_kernel16._bwd_impl16": _PALLAS_SITE,
    "ops.pallas.tile_kernel2.make_forward_kernel": _TPU_LAYOUT,
    "ops.pallas.tile_kernel2.make_backward_kernel": _TPU_LAYOUT,
    "ops.pallas.tile_kernel2._chunk_terms": _TPU_LAYOUT,
    "ops.pallas.tile_kernel2._pixel_rows": _TPU_LAYOUT,
    "ops.pallas.tile_kernel2._scan_add": _TPU_LAYOUT,
    "ops.pallas.tile_kernel2._scan_mul": _TPU_LAYOUT,
    "ops.pallas.tile_kernel2._shift_down": _TPU_LAYOUT,
    "ops.pallas.tile_kernel2.assemble_image": _TPU_LAYOUT,
    "ops.pallas.tile_kernel2.disassemble_image": _TPU_LAYOUT,
    "ops.pallas.tile_kernel16.make_forward_kernel16": _TPU_LAYOUT,
    "ops.pallas.tile_kernel16.make_backward_kernel16": _TPU_LAYOUT,
    "ops.pallas.tile_kernel16._chunk_terms16": _TPU_LAYOUT,
    "ops.pallas.tile_kernel16._pixel_rows16": _TPU_LAYOUT,
    "ops.pallas.tile_kernel16.assemble_image16": _TPU_LAYOUT,
    "ops.pallas.tile_kernel16.disassemble_image16": _TPU_LAYOUT,
    "ops.pallas.tile_kernel16.NBUF": _TPU_LAYOUT,
    "ops.pallas.tile_kernel16.NS": _TPU_LAYOUT,
    "ops.pallas.tile_kernel16.PS": _TPU_LAYOUT,
    "ops.pallas.tile_kernel2.chunk_stats_from_img": _CHUNK_STATS,
    "ops.pallas.tile_kernel16.chunk_stats_from_img16": _CHUNK_STATS,
    "slam.tracking.TrackState": ("the lax.while_loop carry of the IRLS "
                                 "loop; the port loops in Python"),
    "slam.backend.BackEnd._split_key": ("splits a JAX PRNG key; the port "
                                        "draws from a torch.Generator "
                                        "(ROADMAP queue C, mapping "
                                        "departures)"),
    "slam.backend._PREWARMED": _PREWARMED,
    "slam.frontend._PREWARMED": _PREWARMED,
}

# the reference API the port lacked until it was added beside the rest
REFERENCE_API = (
    "ops.losses.depth_reg", "ops.sh.sh0_to_rgb", "ops.camera_math.ndc_to_pix",
    "models.camera.Camera.from_w2c", "slam.backend.BackEnd._assert_finite",
    "slam.backend._NAN_CHECK")


def _is_dunder(name):
    return any(p.startswith("__") and p.endswith("__")
               for p in name.split("."))


def _defined(stmts, out):
    for node in stmts:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(f"{node.name}.{sub.name}" for sub in node.body
                       if isinstance(sub, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out.update(n.id for t in targets for n in ast.walk(t)
                       if isinstance(n, ast.Name) and n.id.isupper())
        elif isinstance(node, (ast.If, ast.Try)):
            for block in ("body", "orelse", "finalbody"):
                _defined(getattr(node, block, []), out)
            for h in getattr(node, "handlers", []):
                _defined(h.body, out)
    return out


def names(path):
    """Top-level functions, classes, methods and UPPER_CASE constants."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return {n for n in _defined(tree.body, set()) if not _is_dunder(n)}


def module_name(rel):
    parts = rel.with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


JAX_MODULES = {module_name(p.relative_to(JAX_PKG)): p
               for p in sorted(JAX_PKG.rglob("*.py"))}


def port_path(jax_module):
    """The port's module at the JAX module's path (ops/pallas/X -> ops/X)."""
    rel = JAX_MODULES[jax_module].relative_to(JAX_PKG)
    return PORT_PKG / pathlib.Path(str(rel).replace("ops/pallas/", "ops/"))


def split(qualified, modules):
    """'pkg.module.Name[.method]' -> (module, name), the longest module
    prefix among ``modules``."""
    best = max((m for m in modules
                if qualified.startswith(m + ".") or m == ""),
               key=len, default=None)
    assert best is not None, qualified
    return best, qualified[len(best) + 1:] if best else qualified


def port_names(rel_module):
    path = PORT_PKG / (rel_module.replace(".", "/") + ".py")
    if not path.exists():
        path = PORT_PKG / rel_module.replace(".", "/") / "__init__.py"
    return names(path) if path.exists() else set()


@pytest.mark.parametrize("jax_module", sorted(JAX_MODULES),
                         ids=lambda m: m or "__init__")
def test_every_jax_name_has_a_port_counterpart(jax_module):
    port = port_path(jax_module)
    assert port.exists(), f"{jax_module}: no port module at {port}"
    have = names(port)
    missing = []
    for name in sorted(names(JAX_MODULES[jax_module])):
        key = f"{jax_module}.{name}" if jax_module else name
        if key in NOT_PORTED:
            assert NOT_PORTED[key].strip(), key
            continue
        if key in ELSEWHERE:
            mod, other = split(ELSEWHERE[key],
                               [module_name(p.relative_to(PORT_PKG))
                                for p in PORT_PKG.rglob("*.py")])
            if other not in port_names(mod):
                missing.append(f"{name} (not at {ELSEWHERE[key]})")
            continue
        if name not in have:
            missing.append(name)
    assert not missing, (
        f"{jax_module}: JAX names with no port counterpart, no ELSEWHERE "
        f"entry and no NOT_PORTED reason: {missing}")


def test_listed_names_still_exist_in_the_jax_sources():
    stale = []
    for key in list(ELSEWHERE) + list(NOT_PORTED) + list(REFERENCE_API):
        mod, name = split(key, JAX_MODULES)
        if name not in names(JAX_MODULES[mod]):
            stale.append(key)
    assert not stale, f"listed names gone from the JAX package: {stale}"


def test_not_ported_names_are_absent_from_the_port():
    ported = [k for k in NOT_PORTED
              if split(k, JAX_MODULES)[1]
              in names(port_path(split(k, JAX_MODULES)[0]))]
    assert not ported, f"listed as not ported, but the port has: {ported}"


@pytest.mark.parametrize("key", REFERENCE_API)
def test_reference_api_is_in_the_port(key):
    mod, name = split(key, JAX_MODULES)
    assert key not in NOT_PORTED and key not in ELSEWHERE
    assert name in names(port_path(mod)), key


# ---------------------------------------------------------------------------
# the Pallas sites and the port's kernel registry
# ---------------------------------------------------------------------------

def pallas_sites():
    """'<path>:<line>' of every pl.pallas_call( in the JAX package and
    scripts/."""
    sites = set()
    for base in (JAX_PKG, ROOT / "scripts"):
        for p in sorted(base.rglob("*.py")):
            for i, line in enumerate(p.read_text().splitlines(), 1):
                if "pl.pallas_call(" in line.split("#", 1)[0]:
                    sites.add(f"{p.relative_to(ROOT).as_posix()}:{i}")
    return sites


def launches_module():
    """The assignments of ops/launches.py, read without importing it (it
    imports torch): its dict literals by name, and the keys of
    COUNTERS."""
    tree = ast.parse(LAUNCHES.read_text())
    env, counters = {}, None
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0].id
        if target == "COUNTERS":
            counters = [k.value for k in node.value.keys]
        else:
            exec(compile(ast.Module([node], []), str(LAUNCHES), "exec"),
                 {"__builtins__": {"dict": dict}}, env)
    return env, counters


def registry():
    """PALLAS_SITES and the keys of COUNTERS."""
    env, counters = launches_module()
    return env["PALLAS_SITES"], counters


def test_pallas_sites_are_the_registry_keys():
    sites, _ = registry()
    found = pallas_sites()
    assert len(found) == 7, sorted(found)
    assert found == set(sites), (
        f"Pallas sites without a port entry: {sorted(found - set(sites))}; "
        f"stale entries: {sorted(set(sites) - found)}")


def test_registry_sources_exist():
    sites, _ = registry()
    used = set()
    for site, v in sites.items():
        rows = {**v["counters"], **v.get("entry", {})}
        assert rows, site
        for name, (src, _note) in rows.items():
            assert src.startswith("csrc/") and (PORT_PKG / src).is_file(), (
                site, name, src)
            used.add(src)
        for entry in v.get("entry", {}):
            path, fn = entry.split(":")
            assert fn in names(PORT_PKG / path), entry
    built = {p.relative_to(PORT_PKG).as_posix()
             for p in (PORT_PKG / "csrc").glob("*.cu")}
    others = set(launches_module()[0]["OTHER_SOURCES"])
    assert not used & others, used & others
    assert used | others == built, (
        f"CUDA sources of no site: {built - used - others}; "
        f"stale: {(used | others) - built}")


def test_every_cuda_source_is_a_built_library():
    """ops/_build.py LIBRARIES builds every CUDA source in csrc/, each one
    library, so that a source a site or OTHER_SOURCES names is built."""
    tree = ast.parse((PORT_PKG / "ops" / "_build.py").read_text())
    libs = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "LIBRARIES")
    sources = [v.elts[0].value for v in libs.values]
    assert len(sources) == len(set(sources)), sources
    built = {p.name for p in (PORT_PKG / "csrc").glob("*.cu")}
    assert set(sources) == built, (
        f"not built: {built - set(sources)}; "
        f"stale: {set(sources) - built}")


def test_registry_counters_cover_COUNTERS():
    """The sites' counters and OTHER_SOURCES' counters, together, are
    COUNTERS exactly: every hand-written kernel a path launches is
    counted, and named once."""
    sites, counters = registry()
    others = launches_module()[0]["OTHER_SOURCES"]
    named = [n for v in sites.values() for n in v["counters"]]
    named += [n for _work, kernels in others.values() for n in kernels]
    assert len(named) == len(set(named)), named
    assert set(named) == set(counters), (
        f"not in COUNTERS: {sorted(set(named) - set(counters))}; "
        f"COUNTERS of no site or source: "
        f"{sorted(set(counters) - set(named))}")
    # B1-B4 launch through COUNTERS; B5 through the port script's entry
    assert all(v["counters"] or v.get("entry") for v in sites.values())


def test_this_file_imports_neither_jax_nor_torch():
    tree = ast.parse(pathlib.Path(__file__).read_text())
    imported = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert not imported & {"jax", "torch", "gs_slam_analytica_jacobian_tpu",
                           "gs_slam_analytica_jacobian_tpu_torch"}, imported
