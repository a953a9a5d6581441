"""Project registry & per-project file layout.

A copy of the JAX package's ``project/manager.py``; behavior parity with
``silencer_ui.py:591-773`` (ProjectManager):
  * registry file  ``<project_dir>/projects.json`` — a list of dicts
    {name, file_list_file, detections_file, review_file,
     silence_status_file, last_accessed}
  * per-project outputs under ``<project_dir>/Softspoken Outputs/<name>/``:
    ``<name>_files.txt``, ``<name>_detections.csv``, ``<name>_review.csv``
  * file list is a sorted, de-duplicated text file (one path per line)
  * ``last_accessed`` strings "%Y-%m-%d %H:%M:%S"; ``activate_latest`` picks
    the lexicographically-latest one
  * legacy layouts are migrated by moving files to the expected paths
"""

from __future__ import annotations

import json
import os
import shutil
from datetime import datetime
from typing import Dict, List, Optional

from ..config import Config, DEFAULT_CONFIG

OUTPUTS_DIRNAME = "Softspoken Outputs"


def _now_str() -> str:
    return datetime.now().strftime("%Y-%m-%d %H:%M:%S")


class ProjectManager:
    def __init__(self, config: Config = DEFAULT_CONFIG):
        self.cfg = config
        self.projects_folder = config.paths.project_dir
        self.outputs_folder = os.path.join(self.projects_folder, OUTPUTS_DIRNAME)
        self.projects_file = os.path.join(self.projects_folder, "projects.json")
        self.projects_data: List[Dict] = []
        self.current_project: Optional[Dict] = None

        os.makedirs(self.outputs_folder, exist_ok=True)
        if os.path.exists(self.projects_file):
            with open(self.projects_file, "r") as f:
                self.projects_data = json.load(f)
            self._migrate_paths()
        else:
            self._write_registry()

    # ---- layout -------------------------------------------------------
    def project_output_dir(self, name: str) -> str:
        return os.path.join(self.outputs_folder, name)

    def _expected_paths(self, name: str) -> Dict[str, str]:
        d = self.project_output_dir(name)
        return {
            "file_list_file": os.path.join(d, f"{name}_files.txt"),
            "detections_file": os.path.join(d, f"{name}_detections.csv"),
            "review_file": os.path.join(d, f"{name}_review.csv"),
        }

    def _migrate_paths(self) -> None:
        """Move project files from legacy locations into the expected layout
        (silencer_ui.py:631-666)."""
        changed = False
        for proj in self.projects_data:
            name = proj.get("name")
            if not name:
                continue
            os.makedirs(self.project_output_dir(name), exist_ok=True)
            for key, expected in self._expected_paths(name).items():
                current = proj.get(key)
                if current == expected:
                    continue
                if current and os.path.exists(current) and not os.path.exists(expected):
                    os.makedirs(os.path.dirname(expected), exist_ok=True)
                    shutil.move(current, expected)
                proj[key] = expected
                changed = True
        if changed:
            self._write_registry()

    # ---- registry ------------------------------------------------------
    def _write_registry(self) -> None:
        # atomic write-then-rename: the registry is rewritten on every
        # grade/open, and an in-place json.dump interrupted mid-write left
        # a truncated projects.json that failed every later launch
        tmp = f"{self.projects_file}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.projects_data, f)
        os.replace(tmp, self.projects_file)

    def list_projects_by_name(self) -> List[str]:
        # tolerate nameless registry entries the loader itself accepts
        # (_migrate_paths skips them) — p["name"] raised KeyError and broke
        # every project flow for such a registry
        return [p["name"] for p in self.projects_data if p.get("name")]

    def add_project(self, name: str) -> Dict:
        # the name becomes a directory and file-stem under the outputs
        # folder: separators / traversal would escape it
        if (not name or name != os.path.basename(name)
                or name in (".", "..") or "/" in name or "\\" in name):
            raise ValueError(f"invalid project name {name!r}")
        if name in self.list_projects_by_name():
            raise ValueError(f"project '{name}' already exists")
        os.makedirs(self.project_output_dir(name), exist_ok=True)
        proj = {
            "name": name,
            **self._expected_paths(name),
            "silence_status_file": "",
            "last_accessed": _now_str(),
        }
        self.projects_data.append(proj)
        self._write_registry()
        return proj

    def set_active_project(self, name: str) -> Optional[Dict]:
        proj = next((p for p in self.projects_data if p["name"] == name), None)
        if proj is not None:
            proj.setdefault("silence_status_file", "")
            proj["last_accessed"] = _now_str()
            self._write_registry()
        self.current_project = proj
        return proj

    def save_current_project(self) -> None:
        if not self.current_project:
            return
        for i, p in enumerate(self.projects_data):
            if p["name"] == self.current_project["name"]:
                self.projects_data[i] = self.current_project
                self._write_registry()
                break

    def activate_latest(self) -> bool:
        if not self.projects_data:
            return False
        latest = max(self.projects_data, key=lambda p: p["last_accessed"])
        self.set_active_project(latest["name"])
        return True

    # ---- file list -----------------------------------------------------
    def get_unprocessed_list(self) -> List[str]:
        """All file paths registered for the active project."""
        if self.current_project is None:
            return []
        path = self.current_project["file_list_file"]
        if not os.path.exists(path):
            return []
        with open(path, "r") as f:
            return [line.strip() for line in f if line.strip()]

    def update_file_list(self, files: List[str]) -> List[str]:
        """Merge, de-duplicate, sort, persist — silencer_ui.py:688-713."""
        if self.current_project is None:
            raise RuntimeError("no active project (call set_active_project)")
        path = self.current_project["file_list_file"]
        unique = set(self.get_unprocessed_list())
        unique.update(files)
        merged = sorted(unique)
        self._write_file_list(path, merged)
        return merged

    def remove_from_file_list(self, files: List[str]) -> List[str]:
        if self.current_project is None:
            raise RuntimeError("no active project (call set_active_project)")
        path = self.current_project["file_list_file"]
        remaining = [p for p in self.get_unprocessed_list() if p not in set(files)]
        self._write_file_list(path, remaining)
        return remaining

    @staticmethod
    def _write_file_list(path: str, names: List[str]) -> None:
        # atomic like _write_registry: a crash between truncate and write
        # would otherwise permanently lose the project's entire registered
        # file list
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.writelines(name + "\n" for name in names)
        os.replace(tmp, path)

    # ---- step status (silencer_ui.py:353-400) --------------------------
    def step_status(self) -> Dict[str, str]:
        """Derive the 3-step workflow status from output file existence/size."""

        def status_of(path: Optional[str]) -> str:
            if not path or not os.path.exists(path):
                return "Not Started"
            return "Complete" if os.path.getsize(path) > 0 else "In Progress"

        proj = self.current_project or {}
        return {
            "detect": status_of(proj.get("detections_file")),
            "review": status_of(proj.get("review_file")),
            "silence": status_of(proj.get("silence_status_file")),
        }
