"""The port's operator image (``Dockerfile.torch``) as a file tree.

No docker runs here: ``tpu_composer_torch.api.image`` replays the
Dockerfile's stages into a temporary directory (the build stage's RUN
line compiles the two native libraries with the port's own builders, on
this host's C++ compiler), and every check starts the port's code from
that tree alone, in a subprocess: ``PYTHONPATH`` is the tree, ``PATH``
holds ``python`` and no compiler, the tree is read-only (and must be
unchanged after each run), and ``torch`` and ``jax`` cannot be imported.
The replay's own COPY and ``.dockerignore`` handling is held to a small
context built here.
"""

from __future__ import annotations

import ast
import importlib.metadata
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from tests.torch_operator import nvidia_host
from tpu_composer_torch.api import image
from tpu_composer_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "tpu_composer_torch"
ENTRY_POINTS = ("tpu_composer_torch", "tpu_composer_torch.agent.serve")
#: What a process in the image cannot import: the image installs neither.
BLOCKED = ("torch", "jax")
_PRELUDE = (f"import sys\nfor _m in {BLOCKED!r}:\n"
            "    sys.modules[_m] = None\n")


#: What a host's tpu_composer_torch/build/ may hold beside the current
#: libraries: a stale build, a CUDA kernel's library, a half-written one.
HOST_LEFTOVERS = ("libgpunode-0123456789abcdef.so",
                  "libflash_fwd-0123456789abcdef.so",
                  "libtpusched-0123456789abcdef.so.77.tmp")


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """The image replayed from a copy of the build context (the package,
    ``Dockerfile.torch`` and its ``.dockerignore``) whose package holds a
    host's build leftovers and bytecode, as a developer's checkout does."""
    ctx = tmp_path_factory.mktemp("context")
    shutil.copytree(os.path.join(REPO, PKG), ctx / PKG)
    for name in ("Dockerfile.torch", "Dockerfile.torch.dockerignore"):
        shutil.copy2(os.path.join(REPO, name), ctx / name)
    for rel in [os.path.join("build", n) for n in HOST_LEFTOVERS] + [
            os.path.join("api", "__pycache__", "image.cpython-312.pyc")]:
        os.makedirs(os.path.dirname(ctx / PKG / rel), exist_ok=True)
        (ctx / PKG / rel).write_text("host")
    out = tmp_path_factory.mktemp("image")
    lay = image.build_layout(str(ctx / "Dockerfile.torch"), str(out))
    image.freeze(lay.final.root)
    lay.before = image.listing(lay.final.root)
    yield lay
    image.thaw(lay.final.root)


def _env(lay, **extra):
    env = image.runtime_env(lay)
    env.update(extra)
    return env


def _run_module_code(module: str, argv) -> str:
    """``python -m <module> <argv>`` with torch and jax blocked."""
    return (_PRELUDE + "import runpy\n"
            f"sys.argv = [{module!r}, *{list(argv)!r}]\n"
            f"runpy.run_module({module!r}, run_name='__main__',"
            " alter_sys=True)\n")


def _python(lay, code: str, cwd, timeout: float = 120.0, **env):
    res = subprocess.run([sys.executable, "-c", code], cwd=str(cwd),
                         env=_env(lay, **env), capture_output=True,
                         text=True, timeout=timeout)
    assert image.listing(lay.final.root) == lay.before, \
        "a process started from the image wrote into its tree"
    return res


def _lib_names(lay) -> set:
    pkg = lay.final.path(PKG)
    return {_build.cxx_library_path(os.path.join(pkg, "native", src),
                                    os.path.join(pkg, "build"), stem).name
            for src, stem in (("gpunode.cc", "gpunode"),
                              ("tpusched.cc", "tpusched"))}


def _maps(pid) -> list:
    with open(f"/proc/{pid}/maps") as f:
        return sorted({ln.split()[-1] for ln in f
                       if re.search(r"lib(gpunode|tpusched)-", ln)})


# ---------------------------------------------------------------------------
# what the Dockerfile says and what the tree holds
# ---------------------------------------------------------------------------


def test_the_runtime_stage_installs_no_torch_jax_cuda_or_compiler(layout):
    build, final = layout.stages
    assert build.installs == {"apt": ["g++"]}
    assert "apt" not in final.installs
    pins = dict(p.split("==") for p in final.installs["pip"])
    assert set(pins) == {"pyyaml", "grpcio", "protobuf"}
    assert all(re.fullmatch(r"\d+(\.\d+)+", v) for v in pins.values()), pins
    banned = re.compile(r"^(torch|jax|jaxlib|triton|nvidia-.*|cuda.*)$")
    assert not [p for p in pins if banned.match(p)]
    assert final.entrypoint == ["python", "-m", PKG]
    assert final.user == "65532:65532"
    assert final.workdir == final.env["PYTHONPATH"] == "/app"


def test_the_layout_holds_the_package_and_exactly_the_two_libraries(layout):
    assert os.listdir(layout.workdir) == [PKG]
    pkg = layout.final.path(PKG)
    built = os.path.join(layout.stages[0].path(PKG), "build")
    libs = sorted(os.listdir(os.path.join(pkg, "build")))
    assert set(libs) == _lib_names(layout)
    for lib in libs:
        with open(os.path.join(pkg, "build", lib), "rb") as a, \
                open(os.path.join(built, lib), "rb") as b:
            assert a.read() == b.read(), lib
    want, got = set(), set()
    for base, into in ((os.path.join(REPO, PKG), want), (pkg, got)):
        for dirpath, dirnames, filenames in os.walk(base):
            rel = os.path.relpath(dirpath, base)
            if rel.split(os.sep)[0] == "build" or "__pycache__" in rel:
                continue
            into.update(os.path.normpath(os.path.join(rel, f))
                        for f in filenames if not f.endswith(".pyc"))
    assert got == want


# ---------------------------------------------------------------------------
# the port's code run from the tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_point_help_runs_without_a_compiler(layout, module, tmp_path):
    res = _python(layout, _run_module_code(module, ["--help"]), tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("usage:")


def test_both_native_libraries_load_from_the_layout(layout, tmp_path):
    code = _PRELUDE + (
        "import json, re, shutil\n"
        "import tpu_composer_torch\n"
        "from tpu_composer_torch.agent import native as agent\n"
        "from tpu_composer_torch.scheduler import native as sched\n"
        "agent.native_lib(); sched.native_lib()\n"
        "maps = sorted({ln.split()[-1] for ln in open('/proc/self/maps')\n"
        "               if re.search(r'lib(gpunode|tpusched)-', ln)})\n"
        "print(json.dumps({'package': tpu_composer_torch.__file__,\n"
        "    'maps': maps, 'logs': [agent.build_log, sched.build_log],\n"
        "    'compilers': [shutil.which(c) for c in ('c++', 'g++', 'cc')]}))\n")
    res = _python(layout, code, tmp_path)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout)
    pkg = layout.final.path(PKG)
    assert out["package"] == os.path.join(pkg, "__init__.py")
    assert out["maps"] == sorted(os.path.join(pkg, "build", n)
                                 for n in _lib_names(layout))
    assert out["logs"] == [{}, {}]
    assert out["compilers"] == [None, None, None]


def _import_closure(root: str, modules) -> dict:
    """{module: file} of ``modules`` and every module of the package they
    import, at the top or inside a function, found by AST under
    ``root``."""
    def file_of(mod):
        base = os.path.join(root, *mod.split("."))
        for f in (base + ".py", os.path.join(base, "__init__.py")):
            if os.path.exists(f):
                return f
        return None

    seen, todo = {}, list(modules)
    while todo:
        mod = todo.pop()
        path = file_of(mod)
        if mod in seen or path is None:
            continue
        seen[mod] = path
        package = mod.split(".")
        if not path.endswith("__init__.py"):
            package = package[:-1]
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                todo += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    up = package[:len(package) - node.level + 1]
                    base = ".".join(up + ([node.module] if node.module
                                          else []))
                todo += [base] + [f"{base}.{a.name}" for a in node.names]
    return seen


def _third_party(paths) -> dict:
    """{top-level name: [modules importing it]} of every import outside
    the standard library and the package."""
    out: dict = {}
    for mod, path in sorted(paths.items()):
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top != PKG and top not in sys.stdlib_module_names:
                    out.setdefault(top, []).append(mod)
    return out


def test_the_entry_points_import_only_what_the_image_installs(layout,
                                                              tmp_path):
    code = _PRELUDE + (
        "import json\n"
        "import tpu_composer_torch.cmd.main, tpu_composer_torch.agent.serve\n"
        "print(json.dumps(sorted(n for n in sys.modules\n"
        "                        if n.split('.')[0] == 'tpu_composer_torch')))\n")
    res = _python(layout, code, tmp_path)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout)
    assert {"tpu_composer_torch.cmd.main", "tpu_composer_torch.agent.serve",
            "tpu_composer_torch.agent.native",
            "tpu_composer_torch.scheduler.native"} <= set(loaded)
    closure = _import_closure(layout.workdir, loaded + [
        f"{m}.__main__" if m == PKG else m for m in ENTRY_POINTS])
    assert "tpu_composer_torch.agent.plugin" in closure  # a lazy import
    dists = {re.sub(r"[-_.]+", "-", p.split("==")[0]).lower()
             for p in layout.final.installs["pip"]}
    installed = {top for top, names
                 in importlib.metadata.packages_distributions().items()
                 if {re.sub(r"[-_.]+", "-", n).lower() for n in names}
                 & dists}
    used = _third_party(closure)
    assert set(used) <= installed, {
        k: v for k, v in used.items() if k not in installed}
    assert {"yaml", "grpc", "google"} <= set(used)


def _wait_http(url_of, proc, timeout: float = 60.0) -> bool:
    """Whether ``url_of()`` (None while the process has not said where it
    listens) answered 200 before ``proc`` exited or the time ran out."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return False
        try:
            url = url_of()
            if url is not None:
                with urllib.request.urlopen(url, timeout=1) as resp:
                    if resp.status == 200:
                        return True
        except OSError:
            pass
        time.sleep(0.05)
    return False


def _serve(layout, tmp_path, module, argv, url_of, **env):
    """Start ``module`` from the tree, wait for ``url_of()`` to answer,
    read its mapped native libraries, SIGTERM it: (maps, rc, log)."""
    log_path = tmp_path / "log.txt"
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", _run_module_code(module, argv)],
            cwd=str(tmp_path), env=_env(layout, **env), stdout=log,
            stderr=subprocess.STDOUT)
    try:
        up = _wait_http(url_of, proc)
        assert up, log_path.read_text()
        maps = _maps(proc.pid)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert image.listing(layout.final.root) == layout.before
    return maps, rc, log_path.read_text()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_the_node_agent_daemon_serves_from_the_layout(layout, tmp_path):
    host = nvidia_host(str(tmp_path / "host"), minors=(0,))
    addr = f"127.0.0.1:{_free_port()}"
    maps, rc, log = _serve(
        layout, tmp_path, "tpu_composer_torch.agent.serve",
        ["--bind", addr, "--dev-dir", host["dev_dir"],
         "--proc-dir", host["proc_dir"], "--cdi-dir", host["cdi_dir"],
         "--state-dir", host["state_dir"]],
        lambda: f"http://{addr}/healthz", NODE_NAME="node-0")
    pkg = layout.final.path(PKG)
    [lib] = [os.path.join(pkg, "build", n) for n in _lib_names(layout)
             if n.startswith("libgpunode-")]
    assert maps == [lib]
    assert f"(native library {lib})" in log
    assert rc == 0, log


def test_the_operator_serves_from_the_layout(layout, tmp_path):
    port_file = tmp_path / "port.json"

    def url():
        if not port_file.exists():
            return None
        with open(port_file) as f:
            return f"http://127.0.0.1:{json.load(f)['health_port']}/readyz"

    maps, rc, log = _serve(
        layout, tmp_path, PKG,
        ["--health-probe-bind-address", "127.0.0.1:0",
         "--port-file", str(port_file),
         "--state-dir", str(tmp_path / "state")],
        url, CDI_PROVIDER_TYPE="MOCK")
    pkg = layout.final.path(PKG)
    [lib] = [os.path.join(pkg, "build", n) for n in _lib_names(layout)
             if n.startswith("libtpusched-")]
    assert maps == [lib]
    assert rc == 0, log


# ---------------------------------------------------------------------------
# the replay itself, on a context built here
# ---------------------------------------------------------------------------


_SMALL_DOCKERFILE = """\
FROM base AS build
WORKDIR /src
RUN apt-get update && apt-get install -y g++ && rm -rf /var/lib/apt/lists/*
COPY pkg/ pkg/
RUN python -c "import os; os.makedirs('pkg/build'); \\
[open(f'pkg/build/{n}', 'w').write(n) for n in ('liba-1.so', 'libb-2.so', 'libc-3.so')]"

FROM base
WORKDIR /app
RUN pip install --no-cache-dir thing==1.0
COPY pkg/ pkg/
COPY --from=build /src/pkg/build/liba-*.so \\
     /src/pkg/build/libb-*.so pkg/build/
COPY top.txt /etc/
ENV PYTHONPATH=/app:/srv/x MODE=1
USER 1:1
ENTRYPOINT ["python", "-m", "pkg"]
"""


def test_the_replay_reads_copy_from_wildcards_and_the_dockerignore(tmp_path):
    ctx = tmp_path / "ctx"
    for rel in ("pkg/__init__.py", "pkg/sub/mod.py", "pkg/build/libz-9.so",
                "pkg/__pycache__/mod.cpython-312.pyc", "pkg/sub/x.pyc",
                "other/big.bin", "top.txt"):
        (ctx / rel).parent.mkdir(parents=True, exist_ok=True)
        (ctx / rel).write_text(rel)
    (ctx / "Dockerfile.small").write_text(_SMALL_DOCKERFILE)
    (ctx / "Dockerfile.small.dockerignore").write_text(
        "# only pkg and top.txt\n*\n!pkg\n!top.txt\npkg/build\n"
        "**/__pycache__\n**/*.pyc\n")
    lay = image.build_layout(str(ctx / "Dockerfile.small"),
                             str(tmp_path / "out"))
    build, final = lay.stages
    assert (build.name, final.name) == ("build", "1")
    assert build.installs == {"apt": ["g++"]}
    assert final.installs == {"pip": ["thing==1.0"]}
    tree = image.listing(final.root)
    files = sorted(p for p in tree if tree[p][0] >= 0)
    assert files == ["app/pkg/__init__.py", "app/pkg/build/liba-1.so",
                     "app/pkg/build/libb-2.so", "app/pkg/sub/mod.py",
                     "etc/top.txt"]
    assert image.runtime_env(lay, {})["PYTHONPATH"] == os.pathsep.join(
        [final.path("/app"), final.path("/srv/x")])
    assert image.runtime_env(lay, {})["PATH"] == lay.bin_dir
    assert final.entrypoint == ["python", "-m", "pkg"]
    assert final.user == "1:1"


@pytest.mark.parametrize("line", [
    "SHELL [\"/bin/bash\", \"-c\"]",
    "ADD pkg.tar.gz /app/",
    "COPY --link pkg/ pkg/",
    "RUN python -c 'print(1)' && pip install thing",
    "ENV PYTHONPATH /app",
])
def test_the_replay_refuses_what_it_cannot_replay(tmp_path, line):
    ctx = tmp_path / "ctx"
    (ctx / "pkg").mkdir(parents=True)
    (ctx / "Dockerfile.small").write_text(f"FROM base\nWORKDIR /app\n{line}\n")
    with pytest.raises(ValueError):
        image.build_layout(str(ctx / "Dockerfile.small"),
                           str(tmp_path / "out"))
