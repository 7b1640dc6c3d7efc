"""The plain reference: frozen/ holds copies of the port's plain versions,
oracle.py rebuilds the cells' frames and train steps with them."""
