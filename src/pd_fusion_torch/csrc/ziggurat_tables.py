"""Print the ziggurat tables of numpy's normal sampler as the C block of
``normal_draw.cu``.

numpy's ``Generator.normal`` (``random_standard_normal`` in its
``distributions.c``) reads three tables of 256 entries: ``ki_double``
(uint64 bounds of the fast accept test), ``wi_double`` and ``fi_double``
(doubles). They sit in the static library that numpy installs,
``numpy/random/lib/libnpyrandom.a``, member ``*distributions.c.o``, as
local symbols of its ``.rodata``. This script reads them from there (an
``ar`` archive of ELF64 objects, parsed here with ``struct``) and prints
them as 64-bit hex words, the doubles by their bits, so the kernel and the
plain version in ``ops/normal_draw.py`` read exactly numpy's values.

    python src/pd_fusion_torch/csrc/ziggurat_tables.py [path/to/libnpyrandom.a]
"""
import struct
import sys
from pathlib import Path

TABLES = ("ki_double", "wi_double", "fi_double")
C_NAMES = {"ki_double": "kKi", "wi_double": "kWiBits", "fi_double": "kFiBits"}
N = 256


def default_library() -> Path:
    import numpy as np

    return Path(np.__file__).resolve().parent / "random" / "lib" / "libnpyrandom.a"


def _members(data: bytes):
    """(name, bytes) of each member of an ``ar`` archive."""
    if data[:8] != b"!<arch>\n":
        raise ValueError("not an ar archive")
    pos, names = 8, b""
    while pos + 60 <= len(data):
        header = data[pos:pos + 60]
        name, size = header[:16].decode().strip(), int(header[48:58])
        body = data[pos + 60:pos + 60 + size]
        if name == "//":  # GNU long-name table
            names = body
        elif name.startswith("/") and name[1:].isdigit():
            start = int(name[1:])
            name = names[start:names.index(b"/\n", start)].decode()
        yield name.rstrip("/"), body
        pos += 60 + size + (size & 1)


def _symbols(elf: bytes):
    """{name: (section file offset + value, size)} of an ELF64 object's symbols."""
    if elf[:4] != b"\x7fELF" or elf[4] != 2 or elf[5] != 1:
        raise ValueError("not a little-endian ELF64 object")
    shoff, = struct.unpack_from("<Q", elf, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", elf, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", elf, shoff + i * shentsize)
                for i in range(shnum)]
    out = {}
    for sh in sections:
        if sh[1] != 2:  # SHT_SYMTAB
            continue
        strtab = sections[sh[6]]
        for k in range(sh[5] // 24):
            st_name, _info, _other, shndx, value, size = struct.unpack_from(
                "<IBBHQQ", elf, sh[4] + 24 * k)
            start = strtab[4] + st_name
            name = elf[start:elf.index(b"\0", start)].decode()
            if 0 < shndx < len(sections):
                out[name] = (sections[shndx][4] + value, size)
    return out


def read_tables(library: Path):
    """{table name: 256 uint64 words} from numpy's ``libnpyrandom.a``."""
    for name, body in _members(Path(library).read_bytes()):
        if not name.endswith("distributions.c.o") or "random_" in name:
            continue
        syms = _symbols(body)
        out = {}
        for t in TABLES:
            offset, size = syms[t]
            if size != 8 * N:
                raise ValueError(f"{t}: {size} bytes, want {8 * N}")
            out[t] = list(struct.unpack_from(f"<{N}Q", body, offset))
        return out
    raise ValueError(f"no distributions object in {library}")


def c_block(tables) -> str:
    lines = []
    for t in TABLES:
        lines.append(f"__device__ const unsigned long long {C_NAMES[t]}[{N}] = {{")
        words = [f"0x{w:016x}ull" for w in tables[t]]
        for i in range(0, N, 4):
            lines.append("    " + ", ".join(words[i:i + 4]) + ",")
        lines.append("};")
    return "\n".join(lines)


if __name__ == "__main__":
    print(c_block(read_tables(Path(sys.argv[1]) if len(sys.argv) > 1 else default_library())))
