"""The checkout's root on the import path, so ``portbench`` imports as a
package under any pytest import mode."""
import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
