import os
import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    """Best-effort build of the native host runtime (optional)."""

    def run(self):
        native_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
        try:
            subprocess.run(["make", "-C", native_dir, "lib"], check=True)
        except Exception:
            print("warning: native library build skipped (no compiler?)")
        super().run()


setup(
    name="bigsi-tpu",
    version="0.1.0",
    description="TPU-native BItsliced Genomic Signature Index (BIGSI)",
    packages=find_packages(exclude=["tests"]),
    python_requires=">=3.10",
    install_requires=["numpy", "jax", "pyyaml"],
    extras_require={"torch": ["torch"]},
    package_data={"bigsi_tpu_torch": ["csrc/*.cu", "csrc/*.cpp"]},
    entry_points={
        "console_scripts": [
            "bigsi-tpu = bigsi_tpu.__main__:main",
            "bigsi-tpu-torch = bigsi_tpu_torch.__main__:main",
        ]
    },
    cmdclass={"build_py": BuildWithNative},
    license="MIT",
)
