"""Minimal legacy-.xls (OLE2 + BIFF8) numeric-cell reader.

NumPy copy of ``rapidnet_tpu/io/xls.py``.

The reference's electricity-price source data is a legacy Excel
workbook (src/paser/dataSource/germany2016.xls) consumed by MATLAB
(src/paser/createDwnDataJson.m).  This is a dependency-free reader for
exactly that use case: extract numeric cells (NUMBER/RK/MULRK records)
per worksheet.  Strings, formulas, formats and everything else are
ignored.

Public API:
    read_xls_numbers(path) -> {sheet_name: {(row, col): float}}
    load_price_series(path, column=None, sheet=None) -> np.ndarray
"""

from __future__ import annotations

import struct

import numpy as np

_OLE_MAGIC = b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1"
_FREE = 0xFFFFFFFF
_ENDCHAIN = 0xFFFFFFFE


def _read_ole_stream(data: bytes, name_candidates) -> bytes:
    """Extract a stream by name from an OLE2 compound file."""
    if data[:8] != _OLE_MAGIC:
        raise ValueError("not an OLE2 compound file (.xls)")
    sector_size = 1 << struct.unpack_from("<H", data, 30)[0]
    mini_size = 1 << struct.unpack_from("<H", data, 32)[0]
    n_fat = struct.unpack_from("<I", data, 44)[0]
    dir_start = struct.unpack_from("<I", data, 48)[0]
    mini_cutoff = struct.unpack_from("<I", data, 56)[0]
    minifat_start = struct.unpack_from("<I", data, 60)[0]
    difat_start = struct.unpack_from("<I", data, 68)[0]
    n_difat = struct.unpack_from("<I", data, 72)[0]

    def sector(i: int) -> bytes:
        off = 512 + i * sector_size
        return data[off:off + sector_size]

    # DIFAT: first 109 FAT sector ids in the header, rest chained
    difat = list(struct.unpack_from("<109I", data, 76))
    s = difat_start
    for _ in range(n_difat):
        if s in (_FREE, _ENDCHAIN):
            break
        blk = sector(s)
        ids = struct.unpack(f"<{sector_size // 4}I", blk)
        difat.extend(ids[:-1])
        s = ids[-1]
    fat_sectors = [i for i in difat[:max(n_fat, 0) + 109] if i != _FREE]
    fat = []
    for i in fat_sectors[:n_fat]:
        fat.extend(struct.unpack(f"<{sector_size // 4}I", sector(i)))

    def chain(start: int) -> bytes:
        out = []
        s = start
        seen = 0
        while s not in (_FREE, _ENDCHAIN) and seen <= len(fat):
            out.append(sector(s))
            s = fat[s]
            seen += 1
        return b"".join(out)

    directory = chain(dir_start)
    entries = []
    for off in range(0, len(directory) - 127, 128):
        raw = directory[off:off + 128]
        name_len = struct.unpack_from("<H", raw, 64)[0]
        if name_len < 2:
            continue
        name = raw[:name_len - 2].decode("utf-16-le", "ignore")
        etype = raw[66]
        start = struct.unpack_from("<I", raw, 116)[0]
        size = struct.unpack_from("<I", raw, 120)[0]
        entries.append((name, etype, start, size))

    # root entry holds the mini stream
    root = next(e for e in entries if e[1] == 5)
    target = None
    for cand in name_candidates:
        for e in entries:
            if e[1] == 2 and e[0] == cand:
                target = e
                break
        if target:
            break
    if target is None:
        raise ValueError(
            f"workbook stream not found (have "
            f"{[e[0] for e in entries if e[1] == 2]})")
    name, _, start, size = target
    if size >= mini_cutoff:
        return chain(start)[:size]
    # stream lives in the mini stream, chained via the mini FAT
    ministream = chain(root[2])[:root[3]]
    minifat = []
    s = minifat_start
    while s not in (_FREE, _ENDCHAIN) and len(minifat) * 4 < 8 * len(data):
        minifat.extend(struct.unpack(f"<{sector_size // 4}I", sector(s)))
        s = fat[s]
    out = []
    s = start
    while s not in (_FREE, _ENDCHAIN):
        out.append(ministream[s * mini_size:(s + 1) * mini_size])
        s = minifat[s]
    return b"".join(out)[:size]


def _decode_rk(rk: int) -> float:
    div100 = rk & 1
    as_int = rk & 2
    if as_int:
        # a signed 30-bit integer in the upper bits (the JAX package's
        # np.int32(rk) overflows on a negative one under NumPy 2)
        v = float(struct.unpack("<i", struct.pack("<I", rk))[0] >> 2)
    else:
        v = struct.unpack("<d", b"\0\0\0\0" +
                          struct.pack("<I", rk & 0xFFFFFFFC))[0]
    return v / 100.0 if div100 else v


def read_xls_numbers(path: str) -> dict[str, dict[tuple[int, int], float]]:
    """All numeric cells of every worksheet: {sheet: {(row, col): val}}."""
    with open(path, "rb") as f:
        data = f.read()
    wb = _read_ole_stream(data, ("Workbook", "Book"))

    # pass 1: BOUNDSHEET records (in workbook globals) -> sheet offsets
    sheets = []   # (stream_pos, name)
    pos = 0
    n = len(wb)
    while pos + 4 <= n:
        op, ln = struct.unpack_from("<HH", wb, pos)
        body = wb[pos + 4:pos + 4 + ln]
        if op == 0x0085 and len(body) >= 8:          # BOUNDSHEET
            sheet_pos = struct.unpack_from("<I", body, 0)[0]
            nm_len = body[6]
            opts = body[7]
            if opts & 1:    # utf-16
                nm = body[8:8 + 2 * nm_len].decode("utf-16-le", "ignore")
            else:
                nm = body[8:8 + nm_len].decode("latin-1", "ignore")
            sheets.append((sheet_pos, nm))
        if op == 0x000A and sheets:                  # EOF of globals
            break
        pos += 4 + ln

    out: dict[str, dict[tuple[int, int], float]] = {}
    for sheet_pos, nm in sheets:
        cells: dict[tuple[int, int], float] = {}
        pos = sheet_pos
        depth = 0
        while pos + 4 <= n:
            op, ln = struct.unpack_from("<HH", wb, pos)
            body = wb[pos + 4:pos + 4 + ln]
            pos += 4 + ln
            if op == 0x0809:                          # BOF
                depth += 1
            elif op == 0x000A:                        # EOF
                depth -= 1
                if depth <= 0:
                    break
            elif op == 0x0203 and ln >= 14:           # NUMBER
                r, c = struct.unpack_from("<HH", body, 0)
                cells[(r, c)] = struct.unpack_from("<d", body, 6)[0]
            elif op == 0x027E and ln >= 10:           # RK
                r, c = struct.unpack_from("<HH", body, 0)
                rk = struct.unpack_from("<I", body, 6)[0]
                cells[(r, c)] = _decode_rk(rk)
            elif op == 0x00BD and ln >= 12:           # MULRK
                r, c0 = struct.unpack_from("<HH", body, 0)
                k = (ln - 6) // 6
                for i in range(k):
                    rk = struct.unpack_from("<I", body, 4 + 6 * i + 2)[0]
                    cells[(r, c0 + i)] = _decode_rk(rk)
            elif op == 0x0006 and ln >= 14:           # FORMULA (cached num)
                r, c = struct.unpack_from("<HH", body, 0)
                raw = body[6:14]
                if raw[6:8] != b"\xff\xff":           # else string/bool/err
                    cells[(r, c)] = struct.unpack("<d", raw)[0]
        out[nm] = cells
    return out


def load_price_series(path: str, column: int | None = None,
                      sheet: str | None = None) -> np.ndarray:
    """Load a 1-D numeric series (e.g. hourly electricity prices).

    Picks the given sheet (default: the one with the most numeric
    cells) and column (default: the column with the most numeric
    entries), ordered by row.
    """
    book = read_xls_numbers(path)
    if sheet is None:
        sheet = max(book, key=lambda k: len(book[k]))
    cells = book[sheet]
    if not cells:
        return np.zeros(0, np.float32)
    if column is None:
        counts: dict[int, int] = {}
        for (_, c) in cells:
            counts[c] = counts.get(c, 0) + 1
        column = max(counts, key=lambda c: counts[c])
    series = sorted((r, v) for (r, c), v in cells.items() if c == column)
    return np.asarray([v for _, v in series], np.float32)


def load_hourly_prices(path: str, sheet: str = "Price (EUR)",
                       date_col: int = 0, hour_cols=range(1, 25)
                       ) -> np.ndarray:
    """Flatten a day-rows x 24-hour-columns price sheet to an hourly
    series, ordered by the date column (germany2016.xls layout: column
    0 is the Excel date serial, columns 1..24 the hourly day-ahead
    prices; DST-skipped hours are filled from the previous hour)."""
    book = read_xls_numbers(path)
    cells = book[sheet]
    dates = sorted((v, r) for (r, c), v in cells.items() if c == date_col)
    out: list[float] = []
    for _, r in dates:
        prev = out[-1] if out else 0.0
        for c in hour_cols:
            v = cells.get((r, c))
            if v is None:
                v = prev
            out.append(float(v))
            prev = v
    return np.asarray(out, np.float32)
