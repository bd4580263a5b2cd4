// Embedding-API end-to-end check (thesis_example_cpp_interface.cpp analog)
// for the PyTorch + CUDA port: load a dataset that carries its optimum
// (xopt / uopt per node), solve with TdunesSolver through the C++ API on
// the given device, and verify the solution against the embedded optimum
// and the KKT bar the reference's own unit tests use (random_qp.c:249-254).
//
// Then the persistent-session latency check (the embedded-MPC pattern,
// treeqp_cpp_interface.cpp:130-430 workspace persistence): n_warm further
// Solve() calls on the SAME QpSolver object reuse the server child, its
// device context and its caches; the fastest warm solve's wall time must
// stay far below a process spawn (no spawn, no re-import per call).
//
// Usage: treeqp_cpp_demo <dataset.json> [n_warm] [device]   (exit 0 on pass)
//   device: cuda (default, the card) or cpu.

#include <cstdio>
#include <cmath>
#include <chrono>
#include <string>
#include <vector>

#include "treeqp_cpp.hpp"

static int Run(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s dataset.json [n_warm] [device]\n", argv[0]);
    return 2;
  }
  const int n_warm = argc > 2 ? std::atoi(argv[2]) : 100;
  const std::string device = argc > 3 ? argv[3] : "cuda";
  treeqp::TreeQp qp = treeqp::TreeQp::FromJsonFile(argv[1]);

  treeqp::TdunesSolver solver(device);
  solver.SetOption("maxit", 200);
  solver.SetOption("stationarityTolerance", 1e-12);

  treeqp::TreeQpOut out;
  int rc = solver.Solve(qp, &out);  // cold: spawns the server
  if (rc != 0) {
    std::fprintf(stderr, "solve failed rc=%d status=%d\n", rc, out.status);
    return 1;
  }

  double max_err = 0.0;
  for (int i = 0; i < qp.NumNodes(); ++i) {
    const auto& nd = qp.node(i);
    for (size_t k = 0; k < nd.xopt.size(); ++k)
      max_err = std::fmax(max_err, std::fabs(nd.xopt[k] - out.nodes[i].x[k]));
    for (size_t k = 0; k < nd.uopt.size(); ++k)
      max_err = std::fmax(max_err, std::fabs(nd.uopt[k] - out.nodes[i].u[k]));
  }
  std::printf("device=%s solver=%s iter=%d status=%d kkt=%.3e max_err_vs_xopt=%.3e "
              "time=%.1fms\n", device.c_str(), out.solver.c_str(), out.num_iter,
              out.status, out.kkt, max_err, 1e3 * out.cpu_time);
  if (out.status != 0) return 1;
  if (out.kkt > 1e-10) return 1;
  if (max_err > 1e-8) return 1;

  // --- warm loop on the persistent session
  double min_wall = 1e30, sum_wall = 0.0, min_cpu = 1e30, min_over = 1e30;
  std::vector<double> walls, cpus;
  for (int k = 0; k < n_warm; ++k) {
    auto t0 = std::chrono::steady_clock::now();
    rc = solver.Solve(qp, &out);
    double wall = std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - t0).count();
    if (rc != 0 || out.kkt > 1e-10) {
      std::fprintf(stderr, "warm solve %d failed rc=%d kkt=%.3e\n", k, rc,
                   out.kkt);
      return 1;
    }
    min_wall = std::fmin(min_wall, wall);
    sum_wall += wall;
    min_cpu = std::fmin(min_cpu, out.cpu_time);
    min_over = std::fmin(min_over, wall - out.cpu_time);
    walls.push_back(wall);
    cpus.push_back(out.cpu_time);
  }
  std::printf(
      "warm x%d: per-solve wall min=%.2fms mean=%.2fms, "
      "reported cpu_time(min)=%.2fms, wall beyond it (min)=%.2fms\n",
      n_warm, 1e3 * min_wall, 1e3 * sum_wall / n_warm, 1e3 * min_cpu,
      1e3 * min_over);
  // latency bar: no process spawn / re-import per call (a spawn alone is
  // ~seconds; the bar fails if session persistence breaks)
  if (n_warm > 0 && min_wall > 0.25) {
    std::fprintf(stderr, "warm solves too slow: session persistence broken\n");
    for (size_t k = 0; k < walls.size(); ++k)
      std::fprintf(stderr, "  warm solve %zu: wall %.2fms, reported cpu_time %.2fms\n", k,
                   1e3 * walls[k], 1e3 * cpus[k]);
    return 1;
  }
  return 0;
}

int main(int argc, char** argv) {
  try {
    return Run(argc, argv);
  } catch (const std::exception& e) {  // a failed solve or session start
    std::fprintf(stderr, "treeqp_cpp_demo: %s\n", e.what());
    return 1;
  }
}
