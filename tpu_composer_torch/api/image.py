"""The port's operator image, ``Dockerfile.torch``, replayed into a
directory without docker.

:func:`build_layout` reads the Dockerfile's stages and rebuilds the file
tree of its last stage: each stage's ``WORKDIR``, ``ENV`` and ``COPY``
lines (``--from=<stage>``, several sources, wildcards; the build context
filtered by ``<Dockerfile>.dockerignore``) and the ``RUN`` lines that run
the port's own code. A ``RUN`` that installs packages (``apt-get``,
``pip``) belongs to the base image: it is recorded in
:attr:`Stage.installs` and not replayed, and the host that replays the
file stands in for it (its C++ compiler for the build stage's ``g++``).
What the runtime stage holds is then checked by running the port's
binaries from :attr:`Layout.workdir` alone, with :func:`runtime_env`: the
image's ``ENV`` mapped into the tree and a ``PATH`` that holds ``python``
and nothing else (no compiler).

The replay reads only what the Dockerfile says, so an edit to it is what
the checks see; an instruction it does not know raises.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shlex
import shutil
import stat
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: Commands whose RUN line installs packages into the base image.
_INSTALLERS = {"apt-get": "apt", "pip": "pip"}


@dataclass
class Stage:
    """One ``FROM`` stage: its base, its WORKDIR, ENV, USER and
    ENTRYPOINT as its last lines leave them, the packages its RUN lines
    install ({"apt": [...], "pip": [...]}), and its filesystem root in
    the replay."""

    name: str
    base: str
    root: str = ""
    workdir: str = "/"
    env: Dict[str, str] = field(default_factory=dict)
    user: Optional[str] = None
    entrypoint: Optional[List[str]] = None
    installs: Dict[str, List[str]] = field(default_factory=dict)
    lines: List[Tuple[str, str]] = field(default_factory=list)

    def path(self, image_path: str) -> str:
        """``image_path`` (absolute, or relative to WORKDIR) in the
        replay's tree."""
        full = os.path.normpath(os.path.join(self.workdir, image_path))
        return os.path.join(self.root, full.lstrip("/"))


@dataclass
class Layout:
    """The replayed image: every stage, the last one's tree and the
    ``bin`` directory whose ``python`` runs this interpreter."""

    stages: List[Stage]
    bin_dir: str

    @property
    def final(self) -> Stage:
        return self.stages[-1]

    @property
    def workdir(self) -> str:
        return self.final.path(self.final.workdir)


def _parse(dockerfile: str) -> List[Stage]:
    """The Dockerfile's stages, each with its instruction lines in order
    (continuation lines joined, comments dropped)."""
    with open(dockerfile) as f:
        text = f.read()
    logical, current = [], ""
    for raw in text.splitlines():
        if not current and (not raw.strip() or raw.lstrip().startswith("#")):
            continue
        if raw.endswith("\\"):
            current += raw[:-1]
            continue
        logical.append(current + raw)
        current = ""
    if current:
        logical.append(current)
    stages: List[Stage] = []
    for line in logical:
        keyword, _, arg = line.strip().partition(" ")
        keyword, arg = keyword.upper(), arg.strip()
        if keyword == "FROM":
            words = arg.split()
            name = (words[2] if len(words) == 3 and words[1].upper() == "AS"
                    else str(len(stages)))
            stages.append(Stage(name=name, base=words[0]))
            continue
        if not stages:
            raise ValueError(f"{dockerfile}: {keyword} before FROM")
        stages[-1].lines.append((keyword, arg))
    if not stages:
        raise ValueError(f"{dockerfile}: no FROM")
    return stages


def _read_ignore(dockerfile: str) -> List[str]:
    """The patterns of ``<dockerfile>.dockerignore`` (empty without one)."""
    path = dockerfile + ".dockerignore"
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.lstrip().startswith("#")]


def _pattern_regex(pattern: str) -> "re.Pattern":
    pattern = os.path.normpath(pattern).lstrip("/")
    out, i = "", 0
    while i < len(pattern):
        if pattern.startswith("**/", i):
            out, i = out + "(?:.*/)?", i + 3
        elif pattern.startswith("**", i):
            out, i = out + ".*", i + 2
        elif pattern[i] == "*":
            out, i = out + "[^/]*", i + 1
        elif pattern[i] == "?":
            out, i = out + "[^/]", i + 1
        else:
            out, i = out + re.escape(pattern[i]), i + 1
    return re.compile(out + r"\Z")


def _ignored(rel_path: str, patterns: List[str]) -> bool:
    """Whether docker leaves ``rel_path`` (relative to the context) out:
    the last pattern that matches it or one of its parent directories
    decides, ``!`` taking it back in."""
    parts = rel_path.strip("/").split("/")
    prefixes = ["/".join(parts[:n]) for n in range(1, len(parts) + 1)]
    out = False
    for pattern in patterns:
        negate = pattern.startswith("!")
        rx = _pattern_regex(pattern[1:] if negate else pattern)
        if any(rx.match(p) for p in prefixes):
            out = not negate
    return out


def _copy_tree(src: str, dest: str, rel: Optional[str],
               patterns: List[str]) -> None:
    """``src``'s contents into ``dest``; ``rel`` is ``src``'s path in the
    build context (None for another stage's tree, which nothing
    filters)."""
    os.makedirs(dest, exist_ok=True)
    for name in sorted(os.listdir(src)):
        s, d = os.path.join(src, name), os.path.join(dest, name)
        r = None if rel is None else (f"{rel}/{name}" if rel else name)
        if r is not None and _ignored(r, patterns):
            continue
        if os.path.isdir(s) and not os.path.islink(s):
            _copy_tree(s, d, r, patterns)
        else:
            shutil.copy2(s, d)


def _copy(stage: Stage, arg: str, context: str, patterns: List[str],
          by_name: Dict[str, Stage]) -> None:
    words = shlex.split(arg)
    source_root, filtered = context, True
    while words and words[0].startswith("--"):
        flag = words.pop(0)
        if not flag.startswith("--from="):
            raise ValueError(f"COPY {flag}: not replayed")
        source_root = by_name[flag[len("--from="):]].root
        filtered = False
    if len(words) < 2:
        raise ValueError(f"COPY {arg}: needs a source and a destination")
    *sources, dest = words
    matches = []
    for source in sources:
        found = sorted(glob.glob(os.path.join(source_root,
                                              source.lstrip("/"))))
        if not found:
            raise FileNotFoundError(f"COPY {source}: nothing matches")
        matches += found
    target = stage.path(dest)
    into_dir = dest.endswith("/") or len(matches) > 1
    for match in matches:
        rel = os.path.relpath(match, source_root).replace(os.sep, "/")
        if filtered and _ignored(rel, patterns):
            continue
        if os.path.isdir(match):
            _copy_tree(match, target, rel if filtered else None, patterns)
        else:
            out = os.path.join(target, os.path.basename(match)) if into_dir \
                else target
            os.makedirs(os.path.dirname(out), exist_ok=True)
            shutil.copy2(match, out)


def _env_words(arg: str) -> Dict[str, str]:
    words = shlex.split(arg)
    if not words or any("=" not in w for w in words):
        raise ValueError(f"ENV {arg}: only KEY=value pairs are replayed")
    return dict(w.split("=", 1) for w in words)


def _installed(command: str) -> Optional[Dict[str, List[str]]]:
    """{manager: packages} when a RUN line installs packages (its first
    command is an installer; what follows is the installer's cleanup),
    else None. A line that runs the port's code must install nothing."""
    parts = [shlex.split(p) for p in command.split("&&")]
    parts = [w for w in parts if w]
    if not parts or parts[0][0] not in _INSTALLERS:
        if any(w[0] in _INSTALLERS for w in parts):
            raise ValueError(f"RUN {command}: an install after other"
                             " commands is not replayed")
        return None
    out: Dict[str, List[str]] = {}
    for w in parts:
        if w[0] in _INSTALLERS and w[1:2] == ["install"]:
            out.setdefault(_INSTALLERS[w[0]], []).extend(
                n for n in w[2:] if not n.startswith("-"))
    return out


def _write_bin(bin_dir: str) -> None:
    os.makedirs(bin_dir, exist_ok=True)
    for name in ("python", "python3"):
        path = os.path.join(bin_dir, name)
        with open(path, "w") as f:
            f.write(f"#!/bin/sh\nexec {shlex.quote(sys.executable)} \"$@\"\n")
        os.chmod(path, 0o755)


def _mapped_env(stage: Stage) -> Dict[str, str]:
    """The stage's ENV with each absolute path (in a ``:``-list too)
    mapped into the replay's tree."""
    return {k: os.pathsep.join(stage.path(p) if p.startswith("/") else p
                               for p in v.split(os.pathsep))
            for k, v in stage.env.items()}


def build_layout(dockerfile: str, out: str) -> Layout:
    """Replay ``dockerfile`` (its directory is the build context) into
    ``out``: each stage's tree under ``out/stage-<name>``. The replay's
    RUN lines see the stage's ENV and a PATH whose ``python`` is this
    interpreter."""
    dockerfile = os.path.abspath(dockerfile)
    context = os.path.dirname(dockerfile)
    patterns = _read_ignore(dockerfile)
    stages = _parse(dockerfile)
    layout = Layout(stages=stages, bin_dir=os.path.join(out, "bin"))
    _write_bin(layout.bin_dir)
    by_name: Dict[str, Stage] = {}
    for stage in stages:
        stage.root = os.path.join(out, "stage-" + stage.name)
        os.makedirs(stage.root)
        for keyword, arg in stage.lines:
            if keyword == "WORKDIR":
                stage.workdir = os.path.normpath(
                    os.path.join(stage.workdir, arg))
                os.makedirs(stage.path(stage.workdir), exist_ok=True)
            elif keyword == "ENV":
                stage.env.update(_env_words(arg))
            elif keyword == "USER":
                stage.user = arg
            elif keyword == "ENTRYPOINT":
                stage.entrypoint = json.loads(arg)
            elif keyword == "COPY":
                _copy(stage, arg, context, patterns, by_name)
            elif keyword == "RUN":
                installed = _installed(arg)
                if installed is not None:
                    for manager, names in installed.items():
                        stage.installs.setdefault(manager, []).extend(names)
                    continue
                env = {k: v for k, v in os.environ.items()
                       if k not in ("PYTHONPATH", "PYTHONHOME")}
                env.update(_mapped_env(stage))
                env["PATH"] = layout.bin_dir + os.pathsep + env.get("PATH", "")
                proc = subprocess.run(
                    ["/bin/sh", "-c", arg], cwd=stage.path(stage.workdir),
                    env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"RUN {arg} exited {proc.returncode}:"
                                       f"\n{proc.stdout}")
            else:
                raise ValueError(f"{keyword} {arg}: not replayed")
        by_name[stage.name] = stage
    return layout


def image_env(layout: Layout) -> Dict[str, str]:
    """What the image sets in a process's environment: the last stage's
    ENV mapped into the tree and a PATH that holds only ``python``.
    Bytecode is not written: the image's user cannot write its tree."""
    return {**_mapped_env(layout.final), "PATH": layout.bin_dir,
            "PYTHONDONTWRITEBYTECODE": "1"}


def runtime_env(layout: Layout, base: Optional[Dict[str, str]] = None
                ) -> Dict[str, str]:
    """The environment of a process started in the image: ``base``
    (default this process's) without its Python path, then
    :func:`image_env`."""
    env = {k: v for k, v in (os.environ if base is None else base).items()
           if k not in ("PYTHONPATH", "PYTHONHOME")}
    env.update(image_env(layout))
    return env


def freeze(root: str) -> None:
    """Take every write permission off the tree under ``root``."""
    for dirpath, dirnames, filenames in os.walk(root):
        for name in filenames:
            path = os.path.join(dirpath, name)
            os.chmod(path, stat.S_IMODE(os.lstat(path).st_mode) & ~0o222)
    for dirpath, _, _ in sorted(os.walk(root), reverse=True):
        os.chmod(dirpath, stat.S_IMODE(os.lstat(dirpath).st_mode) & ~0o222)


def thaw(root: str) -> None:
    """Give the tree under ``root`` back to its owner's writes (to
    remove it)."""
    for dirpath, dirnames, filenames in os.walk(root):
        os.chmod(dirpath, stat.S_IMODE(os.lstat(dirpath).st_mode) | 0o200)
        for name in filenames:
            path = os.path.join(dirpath, name)
            os.chmod(path, stat.S_IMODE(os.lstat(path).st_mode) | 0o200)


def listing(root: str) -> Dict[str, Tuple[int, int]]:
    """Every file under ``root`` by relative path: (size, mtime in ns).
    Two listings taken around a run show whether it wrote the tree."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            path = os.path.join(dirpath, name)
            st = os.lstat(path)
            out[os.path.relpath(path, root)] = (
                st.st_size if not stat.S_ISDIR(st.st_mode) else -1,
                st.st_mtime_ns)
    return out
