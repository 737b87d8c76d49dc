"""Legacy argparse parameter groups, the compatibility surface for
upstream-3DGS tooling (counterpart of ``skelsplat_tpu/arguments.py``, in
the role of the reference's arguments/__init__.py, which only its broken
render.py consumes). The port keeps its own copy.

Original implementation: groups are declarative ``(name, default,
has_shorthand)`` tables rather than reflection over instance attributes,
and the saved-config merge parses ``cfg_args`` with ``ast`` instead of
``eval`` (same accepted inputs — ``Namespace(...)`` reprs with literal
values — without executing arbitrary code).
"""

from __future__ import annotations

import ast
import os
import sys
from argparse import ArgumentParser, Namespace


class GroupParams:
    """Attribute bag returned by ``ParamGroup.extract``."""


class ParamGroup:
    """Builds an argparse group from the subclass's ``SPEC`` table and
    extracts the matching subset of parsed args.

    SPEC rows: ``(flag_name, default, shorthand)`` — ``shorthand=True``
    also registers ``-<first letter>``. bool defaults become store_true
    flags; with ``fill_none=True`` every default is registered as None so
    a later merge can tell "explicitly passed" from "defaulted".
    """

    SPEC: tuple[tuple[str, object, bool], ...] = ()
    TITLE = "Parameters"

    def __init__(self, parser: ArgumentParser, fill_none: bool = False):
        group = parser.add_argument_group(self.TITLE)
        for name, default, shorthand in self.SPEC:
            flags = [f"--{name}"] + ([f"-{name[0]}"] if shorthand else [])
            if isinstance(default, bool):
                group.add_argument(*flags, action="store_true",
                                   default=None if fill_none else default)
            else:
                group.add_argument(*flags, type=type(default),
                                   default=None if fill_none else default)

    def extract(self, args: Namespace) -> GroupParams:
        out = GroupParams()
        mine = {name for name, _, _ in self.SPEC}
        for key, value in vars(args).items():
            if key in mine:
                setattr(out, key, value)
        return out


class ModelParams(ParamGroup):
    """Loading parameters (role of arguments/__init__.py ModelParams)."""

    TITLE = "Loading Parameters"
    SPEC = (
        ("sh_degree", 3, False),
        ("source_path", "", True),
        ("model_path", "", True),
        ("images", "images", True),
        ("depths", "", True),
        ("resolution", -1, True),
        ("white_background", False, True),
        ("train_test_exp", False, False),
        ("data_device", "cuda", False),
        ("eval", False, False),
    )

    def __init__(self, parser: ArgumentParser, sentinel: bool = False):
        super().__init__(parser, fill_none=sentinel)


class PipelineParams(ParamGroup):
    TITLE = "Pipeline Parameters"
    SPEC = (
        ("convert_SHs_python", False, False),
        ("compute_cov3D_python", False, False),
        ("debug", False, False),
        ("antialiasing", False, False),
    )


class OptimizationParams(ParamGroup):
    TITLE = "Optimization Parameters"
    SPEC = (
        ("iterations", 30_000, False),
        ("position_lr_init", 0.00016, False),
        ("position_lr_final", 0.0000016, False),
        ("position_lr_delay_mult", 0.01, False),
        ("position_lr_max_steps", 30_000, False),
        ("feature_lr", 0.0025, False),
        ("opacity_lr", 0.025, False),
        ("scaling_lr", 0.005, False),
        ("rotation_lr", 0.001, False),
        ("exposure_lr_init", 0.01, False),
        ("exposure_lr_final", 0.001, False),
        ("exposure_lr_delay_steps", 0, False),
        ("exposure_lr_delay_mult", 0.0, False),
        ("percent_dense", 0.01, False),
        ("lambda_dssim", 0.2, False),
        ("densification_interval", 100, False),
        ("opacity_reset_interval", 3000, False),
        ("densify_from_iter", 500, False),
        ("densify_until_iter", 15_000, False),
        ("densify_grad_threshold", 0.0002, False),
        ("depth_l1_weight_init", 1.0, False),
        ("depth_l1_weight_final", 0.01, False),
        ("random_background", False, False),
        ("optimizer_type", "default", False),
    )


def parse_namespace_repr(text: str) -> Namespace:
    """Parse a ``Namespace(key=literal, ...)`` repr (the upstream cfg_args
    file format) into a Namespace using ``ast`` — no code execution."""
    tree = ast.parse(text.strip(), mode="eval")
    call = tree.body
    if (not isinstance(call, ast.Call)
            or not isinstance(call.func, ast.Name)
            or call.func.id != "Namespace" or call.args):
        raise ValueError("cfg_args is not a Namespace(...) repr")
    return Namespace(**{kw.arg: ast.literal_eval(kw.value)
                        for kw in call.keywords})


def get_combined_args(parser: ArgumentParser) -> Namespace:
    """Merge the ``cfg_args`` file saved in the model dir with the command
    line; explicitly-passed CLI values win (upstream merge semantics)."""
    cmdline = parser.parse_args(sys.argv[1:])
    merged = {}
    try:
        path = os.path.join(cmdline.model_path, "cfg_args")
        print("Looking for config file in", path)
        with open(path) as f:
            text = f.read()
        print(f"Config file found: {path}")
        merged.update(vars(parse_namespace_repr(text)))
    except (TypeError, FileNotFoundError):
        print("Config file not found at")
    merged.update({k: v for k, v in vars(cmdline).items() if v is not None})
    return Namespace(**merged)
