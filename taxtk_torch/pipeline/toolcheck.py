"""Copy of taxtk/pipeline/toolcheck.py: the port keeps its own copy and imports nothing of taxtk.

External-tool version pinning and verification.

The reference vendors its external binaries at pinned versions with
sha256 verification (reference: contrib/download.tsv:1-6 +
contrib/download-verify.sh): BLAST 2.11.0+, LAST 1170, OrfM 0.7.1,
KronaTools 2.7.1, lz4 1.9.3.  taxtk gates on PATH instead (zero-egress
deployments cannot fetch), which previously meant a deployment could
silently run a different aligner version than the one its refpack was
indexed with.  This module closes that gap:

  * MANIFEST pins the reference's tool versions (and carries the
    reference's artifact sha256 for provenance);
  * verify_external_tools() resolves each requested tool on PATH, asks
    it for its version, and warns (or raises in strict mode) on
    mismatch or absence — called at workflow start
    (pipeline/workflows.py);
  * a refpack may override the expected aligner version with the one it
    was indexed with (refpack_tool_versions/record_tool_versions):
    index-time pins beat the global manifest.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass(frozen=True)
class ToolPin:
    tool: str  # executable name
    version: str  # expected version string (prefix match)
    version_args: tuple  # how to ask the binary
    version_regex: str  # extract the version from stdout+stderr
    artifact_sha256: str  # the reference's pinned artifact (provenance)


# reference: contrib/download.tsv:1-6 (versions embedded in the pinned
# artifact names; sha256 of the artifacts, NOT of the installed binaries)
MANIFEST: Dict[str, ToolPin] = {
    p.tool: p
    for p in [
        ToolPin(
            "blastn", "2.11.0", ("-version",), r"blastn:\s+([\d.]+\+?)",
            "93454cbdf5ba6f541745f31155efd9ba48bc6249fe3659b0aeaea4af62e62b58",
        ),
        ToolPin(
            "blastp", "2.11.0", ("-version",), r"blastp:\s+([\d.]+\+?)",
            "93454cbdf5ba6f541745f31155efd9ba48bc6249fe3659b0aeaea4af62e62b58",
        ),
        ToolPin(
            "makeblastdb", "2.11.0", ("-version",),
            r"makeblastdb:\s+([\d.]+\+?)",
            "93454cbdf5ba6f541745f31155efd9ba48bc6249fe3659b0aeaea4af62e62b58",
        ),
        ToolPin(
            "lastal", "1170", ("--version",), r"lastal\s+([\d.]+)",
            "841b86e90197b41aef36bb5a654fa2f20c6ed99430facac54646ee5a82f92477",
        ),
        ToolPin(
            "lastdb", "1170", ("--version",), r"lastdb\s+([\d.]+)",
            "841b86e90197b41aef36bb5a654fa2f20c6ed99430facac54646ee5a82f92477",
        ),
        ToolPin(
            "orfm", "0.7.1", ("--version",), r"OrfM\s+v?([\d.]+)",
            "ef8c56075fb7908344dea4c0fb1cdd4b6ffb3f76f6388e8b961326e8af39b32f",
        ),
        ToolPin(
            "ktImportText", "2.7.1", (), r"KronaTools\s+([\d.]+)",
            "8fb35e742085ad7cd6ae202fcac05b55e95470361dd409e670fdb62c7e7e6a1a",
        ),
    ]
}

_VERSIONS_FILE = "tool_versions.json"


def probe_tool_version(tool: str, pin: Optional[ToolPin] = None,
                       timeout: float = 10.0) -> Optional[str]:
    """The version string the installed `tool` reports, or None when the
    tool is missing or unqueryable."""
    pin = pin or MANIFEST.get(tool)
    path = shutil.which(tool)
    if path is None or pin is None:
        return None
    try:
        r = subprocess.run(
            [path, *pin.version_args], capture_output=True, text=True,
            timeout=timeout,
        )
        text = (r.stdout or "") + (r.stderr or "")
    except (OSError, subprocess.TimeoutExpired):
        return None
    m = re.search(pin.version_regex, text)
    return m.group(1) if m else None


def record_tool_versions(refpack_dir: str, tools: List[str]) -> Dict[str, str]:
    """Snapshot the CURRENT versions of `tools` into the refpack
    (called at index build time, cli/index.py): classification runs
    then verify against the versions the refpack was indexed with."""
    found = {}
    for t in tools:
        v = probe_tool_version(t)
        if v is not None:
            found[t] = v
    path = os.path.join(refpack_dir, _VERSIONS_FILE)
    try:
        with open(path, "w") as f:
            json.dump(found, f, indent=1, sort_keys=True)
    except OSError:
        pass
    return found


def refpack_tool_versions(refpack_dir: Optional[str]) -> Dict[str, str]:
    if not refpack_dir:
        return {}
    path = os.path.join(refpack_dir, _VERSIONS_FILE)
    try:
        with open(path) as f:
            return dict(json.load(f))
    except (OSError, ValueError):
        return {}


def verify_external_tools(tools: List[str], refpack_dir: Optional[str] = None,
                          strict: bool = False, warn=None) -> List[str]:
    """Check each tool on PATH against its expected version (the
    refpack's recorded version when present, else the reference-pinned
    manifest).  Returns the list of warning strings (also sent through
    `warn`, default stderr); raises in strict mode instead."""
    if warn is None:
        warn = lambda msg: print(f"taxtk: {msg}", file=sys.stderr)
    expected = {t: MANIFEST[t].version for t in tools if t in MANIFEST}
    expected.update(
        {t: v for t, v in refpack_tool_versions(refpack_dir).items()
         if t in tools}
    )
    problems: List[str] = []
    for t in tools:
        want = expected.get(t)
        if shutil.which(t) is None:
            problems.append(
                f"external tool '{t}' not found on PATH "
                f"(expected version {want or 'unknown'}; reference pins "
                f"it via contrib/download.tsv)"
            )
            continue
        got = probe_tool_version(t)
        if want is None or got is None:
            continue  # nothing to compare against / unqueryable
        if not (got == want or got.startswith(want) or want.startswith(got)):
            problems.append(
                f"external tool '{t}' is version {got}, but this "
                f"deployment expects {want}"
                + (" (recorded at refpack index time)"
                   if t in refpack_tool_versions(refpack_dir) else
                   " (reference-pinned version)")
            )
    for p in problems:
        if strict:
            from ..utils.errors import TaxtkError

            raise TaxtkError(p)
        warn(p)
    return problems
