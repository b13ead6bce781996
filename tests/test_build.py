"""Native builds keyed on their inputs and the host (native/build.py), and
the compile-cache placement rule (utils/compile_cache.py)."""

from pathlib import Path

import jax
import pytest

from falcon_r1cs_tpu.native import build
from falcon_r1cs_tpu.utils import compile_cache

ROOT = Path(__file__).resolve().parent.parent


def test_build_key_covers_headers_and_commands(tmp_path):
    src = tmp_path / "a.c"
    hdr = tmp_path / "a.h"
    src.write_text('#include "a.h"\nint f(void) { return A; }\n')
    hdr.write_text("#define A 1\n")
    cmd = [["gcc", "-O2", str(src)]]
    k1 = build.build_key([src, hdr], cmd)
    assert k1 == build.build_key([src, hdr], cmd)
    hdr.write_text("#define A 2\n")
    k2 = build.build_key([src, hdr], cmd)
    assert k2 != k1
    assert build.build_key([src, hdr], [["gcc", "-O3", str(src)]]) != k2


def test_build_key_covers_host(tmp_path, monkeypatch):
    src = tmp_path / "a.c"
    src.write_text("int f(void) { return 1; }\n")
    k1 = build.build_key([src], [["gcc"]])
    monkeypatch.setattr(build, "host_key", lambda: "another cpu")
    assert build.build_key([src], [["gcc"]]) != k1


def test_build_library_builds_once_and_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "ok.c"
    src.write_text("int answer(void) { return 42; }\n")
    cmd = [["gcc", "-shared", "-fPIC", str(src)]]
    so = build.build_library("ok", [src], cmd)
    assert so.exists() and so.parent == tmp_path / "_build"
    mtime = so.stat().st_mtime_ns
    assert build.build_library("ok", [src], cmd) == so
    assert so.stat().st_mtime_ns == mtime  # reused, not rebuilt
    bad = tmp_path / "bad.c"
    bad.write_text("this is not C\n")
    with pytest.raises(RuntimeError, match="building bad failed"):
        build.build_library("bad", [bad], [["gcc", "-shared", str(bad)]])
    assert not list((tmp_path / "_build").glob(".*tmp"))


@pytest.fixture()
def restore_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_inside_checkout(monkeypatch,
                                                restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.configure_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    ignored = (ROOT / ".gitignore").read_text().splitlines()
    assert ".jax_cache/" in ignored
