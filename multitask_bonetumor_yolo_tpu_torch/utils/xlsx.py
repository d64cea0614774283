"""Minimal dependency-free .xlsx reader (stdlib zipfile + ElementTree): the
port's own copy of the JAX package's ``utils/xlsx.py``, which the port may
not import.

The reference converter's contract is ``--meta dataset.xlsx``
(the reference's ``src/pipeline/label_parsing.py:99-104``, read via
``pandas.read_excel`` at :77-83). Neither machine has an excel engine
(openpyxl), so this vendors the tiny subset of OOXML needed to read a flat
metadata sheet: first worksheet, shared strings, inline strings, numbers
and booleans. Not supported (not needed for the contract): formulas'
cached values are read as plain values; dates come back as raw serial
numbers; styles are ignored.
"""

from __future__ import annotations

import re
import zipfile
from typing import Dict, List
from xml.etree import ElementTree


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _col_index(cell_ref: str) -> int:
    """'A1' -> 0, 'BC12' -> 54."""
    col = 0
    for ch in cell_ref:
        if ch.isalpha():
            col = col * 26 + (ord(ch.upper()) - ord("A") + 1)
        else:
            break
    return col - 1


def _cell_value(cell: ElementTree.Element, shared: List[str]):
    ctype = cell.get("t", "n")
    v_text = None
    for child in cell:
        name = _local(child.tag)
        if name == "v":
            v_text = child.text
        elif name == "is":  # inline string
            v_text = "".join(t.text or "" for t in child.iter() if _local(t.tag) == "t")
            return v_text
    if v_text is None:
        return None
    if ctype == "s":
        return shared[int(v_text)]
    if ctype == "b":
        return v_text not in ("0", "false", "FALSE")
    if ctype in ("str", "inlineStr"):
        return v_text
    try:
        f = float(v_text)
        return int(f) if f.is_integer() else f
    except ValueError:
        return v_text


def read_xlsx_rows(path) -> List[List]:
    """First worksheet of ``path`` as a list of rows (lists of cell values,
    None-padded to the rightmost populated column per row)."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        shared: List[str] = []
        if "xl/sharedStrings.xml" in names:
            root = ElementTree.fromstring(zf.read("xl/sharedStrings.xml"))
            for si in root:
                shared.append(
                    "".join(t.text or "" for t in si.iter() if _local(t.tag) == "t")
                )
        sheet_names = sorted(
            n for n in names if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n)
        )
        if not sheet_names:
            raise ValueError(f"{path}: no worksheets found")
        root = ElementTree.fromstring(zf.read(sheet_names[0]))
    rows: List[List] = []
    for row in root.iter():
        if _local(row.tag) != "row":
            continue
        values: List = []
        for cell in row:
            if _local(cell.tag) != "c":
                continue
            ref = cell.get("r")
            idx = _col_index(ref) if ref else len(values)
            while len(values) <= idx:
                values.append(None)
            values[idx] = _cell_value(cell, shared)
        rows.append(values)
    return rows


def read_xlsx_dicts(path) -> List[Dict[str, object]]:
    """First worksheet as dicts keyed by the header row (pandas.read_excel
    orientation, which is what build_type_map consumes)."""
    rows = read_xlsx_rows(path)
    if not rows:
        return []
    header = [str(h) if h is not None else f"col{i}" for i, h in enumerate(rows[0])]
    out = []
    for r in rows[1:]:
        padded = list(r) + [None] * (len(header) - len(r))
        out.append(dict(zip(header, padded)))
    return out


def write_xlsx(path, header: List[str], rows: List[List]) -> None:
    """Write a minimal single-sheet .xlsx (inline strings). Used by tests to
    generate real-format fixtures without openpyxl."""

    def cell(ref: str, v) -> str:
        if isinstance(v, bool):
            return f'<c r="{ref}" t="b"><v>{int(v)}</v></c>'
        if isinstance(v, (int, float)):
            return f'<c r="{ref}"><v>{v}</v></c>'
        return f'<c r="{ref}" t="inlineStr"><is><t>{v}</t></is></c>'

    def col_ref(i: int) -> str:
        s = ""
        i += 1
        while i:
            i, rem = divmod(i - 1, 26)
            s = chr(ord("A") + rem) + s
        return s

    all_rows = [header] + [list(r) for r in rows]
    row_xml = []
    for ri, r in enumerate(all_rows, start=1):
        cells = "".join(cell(f"{col_ref(ci)}{ri}", v) for ci, v in enumerate(r))
        row_xml.append(f'<row r="{ri}">{cells}</row>')
    ns = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
    rns = "http://schemas.openxmlformats.org/officeDocument/2006/relationships"
    pns = "http://schemas.openxmlformats.org/package/2006/relationships"
    sheet = (
        f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f'<worksheet xmlns="{ns}"><sheetData>{"".join(row_xml)}</sheetData></worksheet>'
    )
    workbook = (
        f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f'<workbook xmlns="{ns}" xmlns:r="{rns}"><sheets>'
        f'<sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets></workbook>'
    )
    wb_rels = (
        f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f'<Relationships xmlns="{pns}">'
        f'<Relationship Id="rId1" Type="{rns}/worksheet" '
        f'Target="worksheets/sheet1.xml"/></Relationships>'
    )
    root_rels = (
        f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f'<Relationships xmlns="{pns}">'
        f'<Relationship Id="rId1" '
        f'Type="{rns.replace("relationships", "relationships")}/officeDocument" '
        f'Target="xl/workbook.xml"/></Relationships>'
    )
    ctypes = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
        '<Default Extension="rels" ContentType='
        '"application/vnd.openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType='
        '"application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        '<Override PartName="/xl/worksheets/sheet1.xml" ContentType='
        '"application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
        "</Types>"
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml", ctypes)
        zf.writestr("_rels/.rels", root_rels)
        zf.writestr("xl/workbook.xml", workbook)
        zf.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        zf.writestr("xl/worksheets/sheet1.xml", sheet)
