"""The paper's table drivers (Tables 2, 3 and 4) for the PyTorch port."""
