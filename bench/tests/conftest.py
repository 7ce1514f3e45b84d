import pathlib
import sys

# the program's sources, as ``bench/run.py`` puts them on the path
SRC = pathlib.Path(__file__).resolve().parents[2] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))
