"""ModelTrainer of the port (inference side)."""
