"""The kernel library's name follows every source and header in ``csrc/``.

``build._library_path`` names the library by a hash of the flags and of
every ``.cu``, ``.cuh`` and ``.h`` file, so editing a shared header
rebuilds the kernels instead of loading a stale library.  Runs on a
copy of ``csrc/``; nothing is compiled.
"""
import shutil

from repro_torch.kernels import build


def test_library_name_follows_headers_and_sources(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    assert build._library_path(csrc) == build._library_path()
    first = build._library_path(csrc)
    (csrc / "NOTES.txt").write_text("not a source")
    assert build._library_path(csrc) == first
    header = csrc / "hash_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    second = build._library_path(csrc)
    assert second != first
    (csrc / "extra.h").write_text("#pragma once\n")
    assert build._library_path(csrc) != second
    assert first.parent == build.BUILD_DIR


def test_only_cu_files_compile():
    sources = build._sources()
    assert sources and all(p.suffix == ".cu" for p in sources)
    assert {"fused_ingest.cu", "sigjaccard.cu", "ngram.cu", "minhash.cu",
            "bandfold.cu", "byte_shingle.cu", "flash_attention.cu",
            "flash_attention_f32.cu"} <= {p.name for p in sources}
    assert (build.CSRC / "hash_common.cuh").is_file()
