"""The benchmark's yardstick: operations and least bytes per call, computed
from a configuration file's widths, and the card's peak rates."""
