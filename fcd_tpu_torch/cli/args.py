"""Typed key=value overrides of the CLI's --kwargs.

A copy of `fcd_tpu/cli/args.py::parse_kwargs` (:66-84): each value is
coerced to the type of the default it overrides, and unknown keys are
warned about and skipped.
"""

from __future__ import annotations

from typing import Any, Dict, List


def parse_kwargs(params: Dict[str, Any], kwargs_list: List[str]) -> Dict[str, Any]:
    if not kwargs_list:
        return params
    for kv in kwargs_list:
        if "=" not in kv:
            raise ValueError(f"Invalid kwargs format: {kv}. Use key=value")
        key, value = kv.split("=", 1)
        if key not in params:
            print(f"Warning: Unknown parameter '{key}'")
            continue
        try:
            orig_type = type(params[key])
            if orig_type is bool:
                params[key] = value.lower() in {"true", "1", "yes"}
            else:
                params[key] = orig_type(value)
        except Exception as e:
            raise ValueError(f"Cannot convert '{value}' for '{key}': {e}")
    return params
