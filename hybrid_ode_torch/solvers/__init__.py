"""ODE solvers: fixed-grid RK4 / Euler and the adaptive explicit Runge-Kutta family."""
