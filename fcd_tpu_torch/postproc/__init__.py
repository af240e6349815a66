"""Post-processing of the port's predictions (native C++ or scipy)."""
