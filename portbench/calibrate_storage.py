"""``calibrate.py`` for a cell whose driver takes the program's operator storage as an option.

    python3 portbench/calibrate_storage.py --workload <cell> --seeds 12 --controls 3 --first-seed <n>

The same readings as ``calibrate.py``, in the same form; the control is the
program itself with its operator stored as bf16 (the driver given
``operator_dtype="bf16"``), the nearest precision below complex64. That is the
control ``calibrate.py`` takes for the ``ldos_map`` driver; here it holds for any
driver that passes its options on to the program, such as ``free_energy``.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_readings(cell, program, seed, device):
    """The readings of ``seed``'s first call with the operator stored as bf16."""
    from portbench.harness.record import Call

    driver = cell.driver.Driver(program, cell.config, cell.mix, seed, operator_dtype="bf16")
    units, work, output = driver.call(0)
    return driver.compare([Call(0.0, 0.0, units, work, output)], device)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from portbench import calibrate

    calibrate.control_readings = control_readings
    sys.exit(calibrate.main())
