"""The port's kernel build helper names a library by everything it is
built from: every file in the source's ``csrc/`` directory (the headers a
``.cu`` includes too), the ``nvcc`` flags and the compiler's path.  Pure
Python: no ``nvcc`` is run."""
import pytest

from repro_torch.kernels import _build


def _csrc(tmp_path):
    d = tmp_path / "fam" / "csrc"
    d.mkdir(parents=True)
    (d / "k.cu").write_bytes(b'#include "h.cuh"\nint f() { return X; }\n')
    (d / "h.cuh").write_bytes(b"#define X 1\n")
    return d / "k.cu"


def test_target_is_stable_and_named_after_the_source(tmp_path):
    src = _csrc(tmp_path)
    t = _build._target("k", src, "nvcc")
    assert t == _build._target("k", src, "nvcc")
    assert t.parent == _build.BUILD_DIR
    assert t.name.startswith("k-") and t.suffix == ".so"


@pytest.mark.parametrize("change", ["header bytes", "new header",
                                    "source bytes"])
def test_a_changed_file_in_csrc_renames_the_target(tmp_path, change):
    src = _csrc(tmp_path)
    before = _build._target("k", src, "nvcc")
    if change == "header bytes":
        (src.parent / "h.cuh").write_bytes(b"#define X 2\n")
    elif change == "new header":
        (src.parent / "g.cuh").write_bytes(b"#define Y 1\n")
    else:
        src.write_bytes(src.read_bytes() + b"\n")
    assert _build._target("k", src, "nvcc") != before


def test_flags_defines_and_compiler_rename_the_target(tmp_path,
                                                     monkeypatch):
    src = _csrc(tmp_path)
    before = _build._target("k", src, "nvcc")
    assert _build._target("k", src, "/usr/local/cuda/bin/nvcc") != before
    assert _build._target("k", src, "nvcc", ("X_ONLY",)) != before
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        _build.NVCC_FLAGS + ("-I/usr/local/cutlass/include",))
    assert _build._target("k", src, "nvcc") != before


def test_flash_attention_header_is_part_of_its_build():
    srcs = _build.sources()
    assert sorted(srcs) == ["flash_attention", "minplus", "selective_scan",
                            "selective_scan_bwd", "switch_arb"]
    csrc = srcs["flash_attention"].parent
    assert (csrc / "sm90.cuh").is_file()
    assert b'#include "sm90.cuh"' in srcs["flash_attention"].read_bytes()
