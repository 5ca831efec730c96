"""Where the port's native libraries are built: one choice for the CUDA
kernels (``ops/_build.py``) and the audio runtime (``native/binding.py``).

In a checkout (the package's parent directory holds ``pyproject.toml``)
the libraries go to the git-ignored ``build/mellow_tpu_torch/`` beside the
package; an installed package builds into the user's cache directory,
``$XDG_CACHE_HOME/mellow_tpu_torch`` or else ``~/.cache/mellow_tpu_torch``,
since its parent (``site-packages``) belongs to no package.
"""

from __future__ import annotations

import os

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_dir(package_dir: str = _PKG_DIR) -> str:
    """The build directory of the package at ``package_dir``."""
    root = os.path.dirname(os.path.abspath(package_dir))
    if os.path.isfile(os.path.join(root, "pyproject.toml")):
        return os.path.join(root, "build", "mellow_tpu_torch")
    cache = os.environ.get("XDG_CACHE_HOME", "")
    if not os.path.isabs(cache):  # unset, empty or relative: the XDG default
        cache = os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "mellow_tpu_torch")
