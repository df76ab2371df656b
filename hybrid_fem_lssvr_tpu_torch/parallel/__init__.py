"""Layout transposes and line sweeps (single-device part so far)."""
