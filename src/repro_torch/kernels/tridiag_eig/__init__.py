"""TD2 on Hopper: Sturm bisection and inverse iteration (CUDA C++)."""
