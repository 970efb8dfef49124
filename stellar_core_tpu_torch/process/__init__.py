"""Subprocess runner (reference: src/process)."""

from .process_manager import ProcessManager

__all__ = ["ProcessManager"]
