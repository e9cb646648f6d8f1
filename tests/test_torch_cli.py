"""The port's CLI against brotli_tpu's, on the CPU: `main(argv)` of both
on the same files (each in a directory of its own) leaves the same
files, with the same bytes, permissions and times, writes the same
standard output and error, and returns the same code. Inputs are small
(under 256 KiB), so every compress takes the native route of both
packages; `-d/-t --comment` read the metadata through the Python
decoder of both, and `--base64` and `-D` with a serialized dictionary
run the Python pipeline of both (under 64 KiB, so its host matchers).
Also: one stdin-to-stdout run of `python -m brotli_tpu_torch.cli` and
`-V`.
"""

import os
import pathlib
import stat
import subprocess
import sys

import numpy as np
import pytest

import brotli_tpu
from brotli_tpu import cli as JC
from brotli_tpu_torch import cli as PC
from brotli_tpu_torch.tools.corpus import (base64_page, build_corpus,
                                            custom_dictionary)

REPO = pathlib.Path(__file__).resolve().parent.parent
CORPUS = build_corpus(1 << 20)
TEXT = CORPUS[120_000:170_000]
DICT = CORPUS[20_000:60_000]
MTIME = 1_600_000_000


def _commented():
    c = brotli_tpu.Compressor(quality=5)
    return c.emit_metadata(b"hello") + c.process(TEXT[:30_000]) + c.finish()


def _files():
    stream = brotli_tpu.compress(TEXT, quality=5)
    fuzz = sorted((REPO / "tests" / "fuzz_corpus").iterdir())[0]
    return {
        "text.txt": TEXT,
        "small.bin": fuzz.read_bytes(),
        "rand.bin": np.random.default_rng(0).integers(
            0, 256, 4096, dtype=np.uint8).tobytes(),
        "dict.bin": DICT,
        "a.txt.br": stream,
        "c.txt.br": _commented(),
        "s.txt.bro": brotli_tpu.compress(TEXT[:9000], quality=3),
        "cat.br": brotli_tpu.compress(TEXT[:7000], quality=1)
        + brotli_tpu.compress(TEXT[7000:], quality=9),
        "d.txt.br": brotli_tpu.compress(TEXT, quality=5, dictionary=DICT),
        "l.txt.br": brotli_tpu.compress(TEXT, quality=5, lgwin=26,
                                        large_window=True),
        "bad.br": stream[:len(stream) // 2],
    }


@pytest.fixture(scope="module", autouse=True)
def jax_defaults():
    """The JAX package at its defaults (native encoder and decoder)."""
    with pytest.MonkeyPatch.context() as mp:
        for k in list(os.environ):
            if k.startswith("BROTLI_TPU_"):
                mp.delenv(k)
        yield


def _run(main, root, argv0, argv, extra, monkeypatch, capsysbinary):
    """main(argv) in a fresh directory of the files; returns the code,
    stdout, stderr and every file's (bytes, mode, mtime is MTIME)."""
    root.mkdir()
    for name, data in {**_files(), **extra}.items():
        path = root / name
        path.write_bytes(data)
        os.chmod(path, 0o640)
        os.utime(path, (MTIME, MTIME))
    monkeypatch.chdir(root)
    monkeypatch.setattr(sys, "argv", [argv0])
    capsysbinary.readouterr()
    rc = main(list(argv))
    out, err = capsysbinary.readouterr()
    tree = {}
    for path in sorted(root.iterdir()):
        st = path.stat()
        tree[path.name] = (path.read_bytes(), stat.S_IMODE(st.st_mode),
                           int(st.st_mtime) == MTIME)
    return rc, out, err, tree


CASES = {
    "q5": ("brotli", ["-q", "5", "text.txt"], {}),
    "q1 w16 two files": ("brotli", ["-q", "1", "-w", "16", "text.txt",
                                    "small.bin"], {}),
    "w0 q7": ("brotli", ["-w", "0", "-q", "7", "text.txt"], {}),
    "Z": ("brotli", ["-Z", "text.txt"], {}),
    "D": ("brotli", ["-D", "dict.bin", "-q", "5", "text.txt"], {}),
    "large_window": ("brotli", ["--large_window", "26", "-q", "5",
                                "text.txt"], {}),
    "coalesced 9kf": ("brotli", ["-9kf", "text.txt"], {}),
    "S": ("brotli", ["-S", ".bro", "-q", "3", "text.txt"], {}),
    "o": ("brotli", ["-o", "out.br", "-q", "4", "text.txt"], {}),
    "exists": ("brotli", ["-q", "2", "text.txt"],
               {"text.txt.br": b"junk"}),
    "f": ("brotli", ["-f", "-q", "2", "text.txt"],
          {"text.txt.br": b"junk"}),
    "rm": ("brotli", ["--rm", "-q", "2", "text.txt"], {}),
    "n": ("brotli", ["-n", "-q", "5", "text.txt"], {}),
    "s": ("brotli", ["-s", "-q", "5", "rand.bin", "text.txt"], {}),
    "comment": ("brotli", ["--comment", "hello", "-q", "5", "text.txt"],
                {}),
    "c": ("brotli", ["-c", "-q", "6", "text.txt", "small.bin"], {}),
    "d": ("brotli", ["-d", "a.txt.br"], {}),
    "t": ("brotli", ["-t", "a.txt.br"], {}),
    "t trailing": ("brotli", ["-t", "a.txt.br", "cat.br"], {}),
    "d S": ("brotli", ["-d", "-S", ".bro", "s.txt.bro"], {}),
    "d K": ("brotli", ["-d", "-K", "cat.br"], {}),
    "d D": ("brotli", ["-d", "-D", "dict.bin", "d.txt.br"], {}),
    "d large_window": ("brotli", ["-d", "--large_window", "26",
                                  "l.txt.br"], {}),
    "d truncated": ("brotli", ["-d", "bad.br", "a.txt.br"], {}),
    "d unknown suffix": ("brotli", ["-d", "text.txt"], {}),
    "unbrotli": ("unbrotli", ["a.txt.br"], {}),
    "brcat": ("brcat", ["cat.br"], {}),
    "d comment": ("brotli", ["-d", "--comment", "hello", "c.txt.br"], {}),
    "t comment": ("brotli", ["-t", "--comment", "hello", "c.txt.br"], {}),
    "d wrong comment": ("brotli", ["-d", "--comment", "bye", "c.txt.br"],
                        {}),
    "t no comment": ("brotli", ["-t", "--comment", "hello", "a.txt.br"],
                     {}),
}
FAILING = ("exists", "t trailing", "d truncated", "d unknown suffix",
           "d wrong comment", "t no comment")


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(case, tmp_path, monkeypatch, capsysbinary):
    argv0, argv, extra = CASES[case]
    got = _run(PC.main, tmp_path / "torch", argv0, argv, extra,
               monkeypatch, capsysbinary)
    want = _run(JC.main, tmp_path / "jax", argv0, argv, extra,
                monkeypatch, capsysbinary)
    assert got == want
    assert got[0] == (1 if case in FAILING else 0)


def test_cli_stdin_to_stdout():
    """python -m brotli_tpu_torch.cli: stdin to stdout, both ways."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BROTLI_TPU_")}
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "brotli_tpu_torch.cli"]
    comp = subprocess.run(cmd + ["-c", "-q", "5"], input=TEXT, cwd=REPO,
                          env=env, capture_output=True, timeout=300)
    assert comp.returncode == 0, comp.stderr
    assert comp.stdout == brotli_tpu.compress(TEXT, quality=5)
    back = subprocess.run(cmd + ["-d", "-c"], input=comp.stdout, cwd=REPO,
                          env=env, capture_output=True, timeout=300)
    assert back.returncode == 0, back.stderr
    assert back.stdout == TEXT


def test_cli_version(capsys):
    assert PC.main(["-V"]) == 0
    assert capsys.readouterr().out == \
        f"brotli_tpu_torch {brotli_tpu.__version__}\n"


@pytest.mark.parametrize("argv", [["-d", "--comment", "hello", "c.txt.br"],
                                  ["-t", "--comment", "hello", "c.txt.br"],
                                  ["--base64", "-q", "5", "text.txt"]])
def test_cli_unported_fail_per_file(argv, tmp_path, monkeypatch,
                                    capsysbinary):
    """`-d/-t --comment`, which the JAX package serves with its Python
    decoder, and --base64, which its Python pipeline serves (both
    failed here until they were ported), do what the JAX CLI does:
    the same files and output, code 0."""
    rc, out, err, tree = _run(PC.main, tmp_path / "torch", "brotli", argv,
                              {}, monkeypatch, capsysbinary)
    want = _run(JC.main, tmp_path / "jax", "brotli", argv, {},
                monkeypatch, capsysbinary)
    assert (rc, out, err, tree) == want
    assert rc == 0 and err == b""


def _serialized_files():
    """A page with inline base64 images, and a serialized dictionary
    drawn from the corpus (a prefix and a custom word list) with a
    stream made with it."""
    page = base64_page(CORPUS, 50_000, seed=2)
    blob = custom_dictionary(CORPUS[400_000:400_000 + (64 << 10)])
    # the prefix and the input stay under 64 KiB together: the CLI
    # names no device, and the card's matcher takes 64 KiB or more
    return {"page.html": page, "sd.bin": blob, "t40.txt": TEXT[:40_000],
            "sd.txt.br": brotli_tpu.compress(TEXT, quality=5,
                                             dictionary=blob)}


@pytest.mark.parametrize("argv", [
    ["--base64", "-q", "5", "page.html"],
    ["--base64", "-q", "1", "-c", "page.html"],
    ["-D", "sd.bin", "-q", "5", "t40.txt"],
    ["-d", "-D", "sd.bin", "sd.txt.br"]],
    ids=["base64", "base64 q1 c", "D serialized", "d D serialized"])
def test_cli_base64_and_serialized_dictionaries(argv, tmp_path, monkeypatch,
                                                 capsysbinary):
    """--base64 and -D with a serialized dictionary (its custom words
    through the Python pipeline and the Python decoder): the JAX CLI's
    files and output."""
    extra = _serialized_files()
    got = _run(PC.main, tmp_path / "torch", "brotli", argv, extra,
               monkeypatch, capsysbinary)
    want = _run(JC.main, tmp_path / "jax", "brotli", argv, extra,
                monkeypatch, capsysbinary)
    assert got == want
    assert got[0] == 0 and got[2] == b""
