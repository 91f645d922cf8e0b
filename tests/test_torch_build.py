"""The port's kernel build (emg_tpu_torch/ops/build.py), on the CPU: no
nvcc is needed to name a library or to read the sources.

- A library's name hashes its source and every header under ``csrc/``, so
  an edit to the forward attention header shared by two libraries
  rebuilds both.
- Every C entry point that ``build.SIGNATURES`` declares (and each
  library's ``*_error_string``) is defined with ``extern "C"`` in its source
  or a header it includes (directly or through another header), directly
  or through a macro that expands to one, such as the training library's
  ``FWD_ENTRY``/``BWD_ENTRY``.
- The attention backward's kernels, dq/d_used (K4) and dk/dv (K5), and
  the recompute of p and ds they share live in one header, on the tensor
  cores, which the training library includes; the scalar kernels are gone.
"""

from __future__ import annotations

import re

import pytest

from emg_tpu_torch.ops import build

FORWARD_HEADER = "flash_fwd_relpos.cuh"
BACKWARD_HEADER = "flash_bwd_relpos.cuh"


@pytest.fixture
def tmp_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "shared.cuh"\nextern "C" int k_f32() { return 0; }\n')
    (csrc / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return csrc


@pytest.mark.parametrize("edit", [
    lambda c: (c / "shared.cuh").write_text("// v2\n"),
    lambda c: (c / "other.cuh").write_text("// a new header\n"),
    lambda c: (c / "k.cu").write_text('#include "shared.cuh"\nextern "C" int k_f32() { return 1; }\n'),
], ids=["header_edited", "header_added", "source_edited"])
def test_library_name_follows_sources_and_headers(tmp_csrc, edit):
    before = build._library_path("k")
    assert build._library_path("k") == before  # the name is stable
    assert before.parent == build.BUILD_DIR and before.name.startswith("libk-")
    edit(tmp_csrc)
    assert build._library_path("k") != before


def _with_headers(name: str) -> str:
    """The source of library ``name`` followed by the local headers it
    includes, and the headers they include, each once."""
    text = (build.CSRC / f"{name}.cu").read_text()
    seen = set()
    pending = re.findall(r'#include "([^"]+)"', text)
    while pending:
        header = pending.pop()
        if header not in seen:
            seen.add(header)
            body = (build.CSRC / header).read_text()
            text += body
            pending += re.findall(r'#include "([^"]+)"', body)
    return text


def test_with_headers_follows_nested_includes(tmp_csrc):
    (tmp_csrc / "shared.cuh").write_text('#include "inner.cuh"\n// shared\n')
    (tmp_csrc / "inner.cuh").write_text('#include "shared.cuh"\nextern "C" int inner_f32() { return 0; }\n')
    assert "inner_f32" in _entry_points(_with_headers("k"))


def _entry_points(text: str) -> set:
    names = set(re.findall(r'extern "C"\s+(?:const\s+)?\w+\s*\*?\s*(\w+)\s*\(', text))
    # macros whose body defines an entry point, and the names they are given
    for macro in re.findall(r'#define\s+(\w+)\(NAME\b[^\n]*\\\n\s*extern "C"', text):
        names |= set(re.findall(rf"^{macro}\((\w+),", text, re.MULTILINE))
    return names


@pytest.mark.parametrize("library", sorted(build.SIGNATURES))
def test_every_signature_is_an_entry_point(library):
    assert library in build.SOURCES
    defined = _entry_points(_with_headers(library))
    wanted = set(build.SIGNATURES[library]) | {f"{library}_error_string"}
    assert wanted <= defined, f"not defined as extern \"C\": {sorted(wanted - defined)}"


def test_forward_kernel_is_shared():
    """K2 and K3 are one kernel, defined once, in the header both include."""
    header = (build.CSRC / FORWARD_HEADER).read_text()
    assert "flash_fwd_kernel(" in header and "mma.sync" in header
    for library in ("flash_attention_relpos", "flash_attention_relpos_train"):
        source = (build.CSRC / f"{library}.cu").read_text()
        assert f'#include "{FORWARD_HEADER}"' in source
        assert "flash_fwd_kernel" not in source
        assert FORWARD_HEADER not in build.SOURCES


def test_dkv_kernel_is_the_backward_headers():
    """K5 is defined once, in the backward header, which reuses the forward
    header's primitives and holds the shared recompute; the training
    library includes it, and the scalar dk/dv and dq kernels are gone."""
    header = (build.CSRC / BACKWARD_HEADER).read_text()
    assert "flash_bwd_dkv_kernel(" in header and "recompute_pd_ds(" in header
    assert f'#include "{FORWARD_HEADER}"' in header
    for primitive in ("fwd::gemm_qbt", "fwd::mma_bf16", "fwd::mma_3xtf32", "fwd::ldsm_x4_trans"):
        assert primitive in header
    assert "mma.sync" in _with_headers("flash_attention_relpos_train")
    source = (build.CSRC / "flash_attention_relpos_train.cu").read_text()
    assert f'#include "{BACKWARD_HEADER}"' in source
    assert "flash_bwd_dkv_kernel" not in source and "flash_train_bwd_dkv_kernel" not in source
    assert "flash_train_bwd_dq_kernel" not in source  # K4 left the source
    assert "__global__" not in source  # only entry points remain
    assert BACKWARD_HEADER not in build.SOURCES


def test_dq_kernel_is_the_backward_headers():
    """K4 is defined once, in the backward header: it calls the shared
    recompute and runs its products on the forward header's mma
    primitives; no other source defines it."""
    header = (build.CSRC / BACKWARD_HEADER).read_text()
    assert header.count("flash_bwd_dq_kernel(") == 1
    body = header[header.index("flash_bwd_dq_kernel("):header.index("int launch_dq(")]
    assert "recompute_pd_ds<T, kDh, kN>(" in body
    for primitive in ("fwd::mma_bf16", "fwd::mma_3xtf32", "fwd::ldsm_x4_trans"):
        assert primitive in body
    assert "atomicAdd" in body  # d_used across blocks
    for path in build.CSRC.iterdir():
        if path.name != BACKWARD_HEADER:
            assert "flash_bwd_dq_kernel" not in path.read_text()


@pytest.mark.parametrize("capturing", [False, True])
def test_count_launch_skips_calls_under_capture(monkeypatch, capturing):
    """A wrapper's call under CUDA graph capture launches nothing and is not
    counted; any other call is."""
    import torch

    def wrapper():
        pass

    wrapper.launches = 3
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    build.count_launch(wrapper)
    assert wrapper.launches == (3 if capturing else 4)
