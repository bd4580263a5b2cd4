// treeqp_cpp — high-level C++ embedding API for treeqp_tpu_torch.
//
// The analog of the reference's C++ interface classes
// (interfaces/treeqp_cpp/treeqp_cpp_interface.hpp:43-175: TreeQp owning
// qp_in/qp_out with string-keyed setters, abstract QpSolver with
// TdunesSolver/HpmpcSolver and SetOption overloads), for the PyTorch + CUDA
// port: the compute path lives in the port's Python process on the card,
// and a C++ application embeds it through the same JSON protocol the
// reference's own benchmark harness uses to drive its solve_qp_json
// executable (benchmark/utils/treeqp_solve.m:6-17,
// examples/solve_qp_json.cpp:206-615). Data preparation, validation,
// serialization and solution parsing are native C++ (this header + the C ABI
// tree-graph constructor and packer in treeqp_host.cpp); Solve() talks
// JSON-lines to ONE persistent
// `python3 -m treeqp_tpu_torch.interfaces.cli --serve --device D` child
// (SolverSession below) whose CUDA context, built kernels and solver caches
// persist across solves — the workspace-persistence analog of the
// reference's in-process C++ API (treeqp_cpp_interface.cpp:130-430).
//
// The device D is "cuda" (the card, the default) or "cpu"; the solver
// process refuses a device that is not there. The interpreter is
// `python3`, or TREEQP_PYTHON if set; TREEQP_ROOT (or the current
// directory) must contain the treeqp_tpu_torch package.
//
// Header-only, no external dependencies (a minimal JSON reader/writer is
// included — nlohmann/json is not vendored in this toolchain).

#ifndef TREEQP_TORCH_CPP_HPP_
#define TREEQP_TORCH_CPP_HPP_

#include <fcntl.h>
#include <signal.h>
#include <sys/wait.h>
#include <unistd.h>

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace treeqp {

// ---------------------------------------------------------------------------
// Minimal JSON value (objects, arrays, numbers, strings, bools, null).

class Json {
 public:
  enum Kind { kNull, kBool, kNumber, kString, kArray, kObject };

  Json() : kind_(kNull) {}
  explicit Json(bool b) : kind_(kBool), bool_(b) {}
  explicit Json(double d) : kind_(kNumber), num_(d) {}
  explicit Json(const std::string& s) : kind_(kString), str_(s) {}

  static Json Array() { Json j; j.kind_ = kArray; return j; }
  static Json Object() { Json j; j.kind_ = kObject; return j; }

  Kind kind() const { return kind_; }
  bool is_null() const { return kind_ == kNull; }
  double num() const { return num_; }
  bool boolean() const { return bool_; }
  const std::string& str() const { return str_; }
  const std::vector<Json>& arr() const { return arr_; }
  std::vector<Json>& arr() { return arr_; }

  bool has(const std::string& k) const { return obj_.count(k) > 0; }
  const Json& at(const std::string& k) const { return obj_.at(k); }
  Json& operator[](const std::string& k) {
    kind_ = kObject;
    return obj_[k];
  }
  void push_back(Json v) { kind_ = kArray; arr_.push_back(std::move(v)); }

  std::vector<double> as_doubles() const {
    std::vector<double> out;
    out.reserve(arr_.size());
    for (const auto& v : arr_) out.push_back(v.num());
    return out;
  }

  // Parse -----------------------------------------------------------------
  static Json Parse(const std::string& text) {
    size_t pos = 0;
    Json v = ParseValue(text, pos);
    SkipWs(text, pos);
    if (pos != text.size()) throw std::runtime_error("json: trailing data");
    return v;
  }

  static Json ParseFile(const std::string& path) {
    std::ifstream f(path);
    if (!f) throw std::runtime_error("json: cannot open " + path);
    std::stringstream ss;
    ss << f.rdbuf();
    return Parse(ss.str());
  }

  // Serialize -------------------------------------------------------------
  void Dump(std::string* out) const {
    char buf[64];
    switch (kind_) {
      case kNull: *out += "null"; break;
      case kBool: *out += bool_ ? "true" : "false"; break;
      case kNumber:
        if (std::isfinite(num_)) {
          std::snprintf(buf, sizeof(buf), "%.17g", num_);
          *out += buf;
        } else {  // JSON has no inf; the loader treats 1e12 as TREEQP_INF
          *out += num_ > 0 ? "1e30" : "-1e30";
        }
        break;
      case kString: DumpString(str_, out); break;
      case kArray: {
        *out += '[';
        for (size_t i = 0; i < arr_.size(); ++i) {
          if (i) *out += ',';
          arr_[i].Dump(out);
        }
        *out += ']';
        break;
      }
      case kObject: {
        *out += '{';
        bool first = true;
        for (const auto& kv : obj_) {
          if (!first) *out += ',';
          first = false;
          DumpString(kv.first, out);
          *out += ':';
          kv.second.Dump(out);
        }
        *out += '}';
        break;
      }
    }
  }

  std::string Dump() const {
    std::string s;
    Dump(&s);
    return s;
  }

 private:
  static void SkipWs(const std::string& t, size_t& p) {
    while (p < t.size() && (t[p] == ' ' || t[p] == '\t' || t[p] == '\n' ||
                            t[p] == '\r'))
      ++p;
  }

  static Json ParseValue(const std::string& t, size_t& p) {
    SkipWs(t, p);
    if (p >= t.size()) throw std::runtime_error("json: eof");
    char c = t[p];
    if (c == '{') return ParseObject(t, p);
    if (c == '[') return ParseArray(t, p);
    if (c == '"') return Json(ParseString(t, p));
    if (t.compare(p, 4, "true") == 0) { p += 4; return Json(true); }
    if (t.compare(p, 5, "false") == 0) { p += 5; return Json(false); }
    if (t.compare(p, 4, "null") == 0) { p += 4; return Json(); }
    // number
    size_t end = p;
    while (end < t.size() &&
           (std::isdigit((unsigned char)t[end]) || t[end] == '-' ||
            t[end] == '+' || t[end] == '.' || t[end] == 'e' || t[end] == 'E'))
      ++end;
    if (end == p) throw std::runtime_error("json: bad value");
    Json v(std::stod(t.substr(p, end - p)));
    p = end;
    return v;
  }

  static std::string ParseString(const std::string& t, size_t& p) {
    if (t[p] != '"') throw std::runtime_error("json: expected string");
    ++p;
    std::string s;
    while (p < t.size() && t[p] != '"') {
      if (t[p] == '\\' && p + 1 < t.size()) {
        ++p;
        switch (t[p]) {
          case 'n': s += '\n'; break;
          case 't': s += '\t'; break;
          case 'r': s += '\r'; break;
          case '"': s += '"'; break;
          case '\\': s += '\\'; break;
          case '/': s += '/'; break;
          default: s += t[p];
        }
      } else {
        s += t[p];
      }
      ++p;
    }
    if (p >= t.size()) throw std::runtime_error("json: unterminated string");
    ++p;
    return s;
  }

  static Json ParseArray(const std::string& t, size_t& p) {
    Json a = Array();
    ++p;  // [
    SkipWs(t, p);
    if (p < t.size() && t[p] == ']') { ++p; return a; }
    while (true) {
      a.arr_.push_back(ParseValue(t, p));
      SkipWs(t, p);
      if (p >= t.size()) throw std::runtime_error("json: eof in array");
      if (t[p] == ',') { ++p; continue; }
      if (t[p] == ']') { ++p; return a; }
      throw std::runtime_error("json: bad array");
    }
  }

  static Json ParseObject(const std::string& t, size_t& p) {
    Json o = Object();
    ++p;  // {
    SkipWs(t, p);
    if (p < t.size() && t[p] == '}') { ++p; return o; }
    while (true) {
      SkipWs(t, p);
      std::string key = ParseString(t, p);
      SkipWs(t, p);
      if (p >= t.size() || t[p] != ':')
        throw std::runtime_error("json: missing colon");
      ++p;
      o.obj_[key] = ParseValue(t, p);
      SkipWs(t, p);
      if (p >= t.size()) throw std::runtime_error("json: eof in object");
      if (t[p] == ',') { ++p; continue; }
      if (t[p] == '}') { ++p; return o; }
      throw std::runtime_error("json: bad object");
    }
  }

  static void DumpString(const std::string& s, std::string* out) {
    *out += '"';
    for (char c : s) {
      if (c == '"' || c == '\\') { *out += '\\'; *out += c; }
      else if (c == '\n') *out += "\\n";
      else *out += c;
    }
    *out += '"';
  }

  Kind kind_;
  bool bool_ = false;
  double num_ = 0.0;
  std::string str_;
  std::vector<Json> arr_;
  std::map<std::string, Json> obj_;
};

// ---------------------------------------------------------------------------
// QP data container (tree_qp_in analog; treeqp_cpp_interface.hpp:43-108).

struct NodeData {
  std::vector<double> Q, R, S;       // row-major nx*nx, nu*nu, nu*nx
  std::vector<double> q, r;          // nx, nu
  std::vector<double> lx, ux, lu, uu;
  std::vector<double> C, D, ld, ud;  // nc*nx, nc*nu, nc, nc
  std::vector<double> xopt, uopt;    // optional embedded reference solution
};

struct EdgeData {
  int from = -1, to = -1;
  std::vector<double> A, B, b;  // row-major nx_to*nx_from, nx_to*nu_from
};

struct NodeSolution {
  std::vector<double> x, u, mu_x, mu_u, mu_d;
};

struct TreeQpOut {
  std::vector<NodeSolution> nodes;
  std::vector<std::vector<double>> lam;  // per edge (into node 1..Nn-1)
  double kkt = 0.0, cpu_time = 0.0;
  // solver-vs-interface split (treeqp_info_t, tree_qp_common.h:43-51)
  double solver_time = 0.0, interface_time = 0.0;
  int num_iter = -1, status = -1;
  std::string solver;  // actual engine used (e.g. "tdunes_ms" after
                       // multistage dispatch; see interfaces/cli.py)
};

class TreeQp {
 public:
  // Build from per-node dims and children counts (the reference constructor
  // takes vector<int> nx, nu, nc, nk — treeqp_cpp_interface.cpp:130-180).
  TreeQp(std::vector<int> nx, std::vector<int> nu, std::vector<int> nc,
         const std::vector<int>& nk)
      : nx_(std::move(nx)), nu_(std::move(nu)), nc_(std::move(nc)) {
    const int nn = (int)nx_.size();
    parent_.assign(nn, -1);
    int next = 1;
    for (int i = 0; i < nn; ++i) {
      for (int j = 0; j < nk[i]; ++j) {
        if (next >= nn) throw std::runtime_error("treeqp: inconsistent nk");
        parent_[next++] = i;
      }
    }
    if (next != nn) throw std::runtime_error("treeqp: inconsistent nk");
    nodes_.resize(nn);
    edges_.resize(nn > 0 ? nn - 1 : 0);
    for (int cnode = 1; cnode < nn; ++cnode) {
      edges_[cnode - 1].from = parent_[cnode];
      edges_[cnode - 1].to = cnode;
    }
  }

  int NumNodes() const { return (int)nodes_.size(); }
  const NodeData& node(int i) const { return nodes_[i]; }
  NodeData& node(int i) { return nodes_[i]; }
  EdgeData& edge_into(int child) { return edges_[child - 1]; }

  // String-keyed setters (SetVector / SetMatrixColMajor,
  // treeqp_cpp_interface.hpp:60-84). Matrices arrive column-major with
  // leading dimension = rows, exactly like the reference setters
  // (tree_qp_common.c:874-2427), and are transposed to row-major here.
  void SetVector(const std::string& field, int idx, const double* v, int n) {
    std::vector<double>* dst = VectorField(field, idx);
    dst->assign(v, v + n);
  }

  void SetMatrixColMajor(const std::string& field, int idx, const double* v,
                         int m, int n) {
    std::vector<double>* dst = MatrixField(field, idx);
    dst->resize((size_t)m * n);
    for (int j = 0; j < n; ++j)
      for (int i = 0; i < m; ++i) (*dst)[(size_t)i * n + j] = v[(size_t)j * m + i];
  }

  // JSON round-trip (reference dataset schema: examples/random_qp_utils/
  // data00.json — nodes[] / edges[] with row-major nested lists).
  static TreeQp FromJsonFile(const std::string& path) {
    Json j = Json::ParseFile(path);
    const auto& nodes = j.at("nodes").arr();
    const auto& edges = j.at("edges").arr();
    const int nn = (int)nodes.size();
    std::vector<int> nx(nn), nu(nn), nc(nn, 0), nk(nn, 0);
    std::vector<int> parent(nn, -1);
    for (const auto& e : edges) {
      int to = (int)e.at("to").num(), from = (int)e.at("from").num();
      parent[to] = from;
      nk[from] += 1;
    }
    for (int i = 0; i < nn; ++i) {
      nx[i] = (int)VecOf(nodes[i], "q").size();
      nu[i] = nodes[i].has("r") ? (int)VecOf(nodes[i], "r").size() : 0;
      nc[i] = nodes[i].has("ld") ? (int)VecOf(nodes[i], "ld").size() : 0;
    }
    TreeQp qp(nx, nu, nc, nk);
    for (int i = 0; i < nn; ++i) {
      const Json& nd = nodes[i];
      NodeData& d = qp.nodes_[i];
      d.Q = MatOf(nd, "Q");
      d.R = MatOf(nd, "R");
      d.S = MatOf(nd, "S");
      d.q = VecOf(nd, "q");
      d.r = VecOf(nd, "r");
      d.lx = VecOf(nd, "lx");
      d.ux = VecOf(nd, "ux");
      d.lu = VecOf(nd, "lu");
      d.uu = VecOf(nd, "uu");
      d.C = MatOf(nd, "C");
      d.D = MatOf(nd, "D");
      d.ld = VecOf(nd, "ld");
      d.ud = VecOf(nd, "ud");
      d.xopt = VecOf(nd, "xopt");
      d.uopt = VecOf(nd, "uopt");
    }
    for (const auto& e : edges) {
      int to = (int)e.at("to").num();
      EdgeData& d = qp.edges_[to - 1];
      d.from = (int)e.at("from").num();
      d.to = to;
      d.A = MatOf(e, "A");
      d.B = MatOf(e, "B");
      d.b = VecOf(e, "b");
    }
    return qp;
  }

  Json ToJson(const Json* options) const {
    Json root = Json::Object();
    Json nodes = Json::Array();
    for (int i = 0; i < NumNodes(); ++i) {
      const NodeData& d = nodes_[i];
      Json nd = Json::Object();
      nd["Q"] = MatJson(d.Q, nx_[i], nx_[i]);
      nd["R"] = MatJson(d.R, nu_[i], nu_[i]);
      nd["S"] = MatJson(d.S, nu_[i], nx_[i]);
      nd["q"] = VecJson(d.q);
      nd["r"] = VecJson(d.r);
      if (!d.lx.empty()) nd["lx"] = VecJson(d.lx);
      if (!d.ux.empty()) nd["ux"] = VecJson(d.ux);
      if (!d.lu.empty()) nd["lu"] = VecJson(d.lu);
      if (!d.uu.empty()) nd["uu"] = VecJson(d.uu);
      if (nc_[i] > 0) {
        nd["C"] = MatJson(d.C, nc_[i], nx_[i]);
        nd["D"] = MatJson(d.D, nc_[i], nu_[i]);
        nd["ld"] = VecJson(d.ld);
        nd["ud"] = VecJson(d.ud);
      }
      nodes.push_back(std::move(nd));
    }
    Json edges = Json::Array();
    for (const auto& e : edges_) {
      Json ed = Json::Object();
      ed["from"] = Json((double)e.from);
      ed["to"] = Json((double)e.to);
      ed["A"] = MatJson(e.A, nx_[e.to], nx_[e.from]);
      ed["B"] = MatJson(e.B, nx_[e.to], nu_[e.from]);
      ed["b"] = VecJson(e.b);
      edges.push_back(std::move(ed));
    }
    root["nodes"] = std::move(nodes);
    root["edges"] = std::move(edges);
    if (options) root["options"] = *options;
    return root;
  }

 private:
  // Scalars stand in for 1-vectors and 1x1 matrices in the reference
  // datasets (random_qp_utils/data0*.json); flatten all forms row-major.
  static std::vector<double> Flatten(const Json& v) {
    std::vector<double> out;
    if (v.kind() == Json::kNumber) {
      out.push_back(v.num());
    } else if (v.kind() == Json::kArray) {
      for (const auto& e : v.arr()) {
        if (e.kind() == Json::kArray)
          for (const auto& x : e.arr()) out.push_back(x.num());
        else
          out.push_back(e.num());
      }
    }
    return out;
  }

  static std::vector<double> VecOf(const Json& o, const std::string& k) {
    if (!o.has(k) || o.at(k).is_null()) return {};
    return Flatten(o.at(k));
  }

  static std::vector<double> MatOf(const Json& o, const std::string& k) {
    if (!o.has(k) || o.at(k).is_null()) return {};
    return Flatten(o.at(k));
  }

  static Json VecJson(const std::vector<double>& v) {
    Json a = Json::Array();
    for (double x : v) a.push_back(Json(x));
    return a;
  }

  static Json MatJson(const std::vector<double>& m, int rows, int cols) {
    Json a = Json::Array();
    for (int i = 0; i < rows; ++i) {
      Json row = Json::Array();
      for (int j = 0; j < cols; ++j) row.push_back(Json(m[(size_t)i * cols + j]));
      a.push_back(std::move(row));
    }
    return a;
  }

  std::vector<double>* VectorField(const std::string& f, int i) {
    NodeData& d = nodes_[i];
    if (f == "q") return &d.q;
    if (f == "r") return &d.r;
    if (f == "lx" || f == "xmin") return &d.lx;
    if (f == "ux" || f == "xmax") return &d.ux;
    if (f == "lu" || f == "umin") return &d.lu;
    if (f == "uu" || f == "umax") return &d.uu;
    if (f == "ld" || f == "dmin") return &d.ld;
    if (f == "ud" || f == "dmax") return &d.ud;
    if (f == "b") return &edges_[i - 1].b;
    throw std::runtime_error("treeqp: unknown vector field " + f);
  }

  std::vector<double>* MatrixField(const std::string& f, int i) {
    NodeData& d = nodes_[i];
    if (f == "Q") return &d.Q;
    if (f == "R") return &d.R;
    if (f == "S") return &d.S;
    if (f == "C") return &d.C;
    if (f == "D") return &d.D;
    if (f == "A") return &edges_[i - 1].A;
    if (f == "B") return &edges_[i - 1].B;
    throw std::runtime_error("treeqp: unknown matrix field " + f);
  }

  std::vector<int> nx_, nu_, nc_, parent_;
  std::vector<NodeData> nodes_;
  std::vector<EdgeData> edges_;
};

// ---------------------------------------------------------------------------
// SolverSession — persistent solve server (the in-process embedding path).
//
// The reference C++ API holds the solver workspace in the TreeQp/QpSolver
// objects and calls treeqp_tdunes_solve in-process, so solve #2..N costs
// only solver time (treeqp_cpp_interface.cpp:130-430). Here the compute
// path lives in the port's Python process: the equivalent persistence is
// ONE long-lived `python3 -m treeqp_tpu_torch.interfaces.cli --serve
// --device D` child whose CUDA context, kernel library and per-topology
// caches survive across solves. The session speaks JSON-lines over a
// stdin/stdout pipe pair; after the first solve, per-solve wall time is
// the solve plus the JSON round trip (vs seconds for a process spawn,
// the torch import and the device's set-up).

// The interpreter that runs the port: TREEQP_PYTHON, else python3.
inline std::string PythonExecutable() {
  const char* py = std::getenv("TREEQP_PYTHON");
  return py ? py : "python3";
}

class SolverSession {
 public:
  explicit SolverSession(std::string device = "cuda") : device_(std::move(device)) {}
  ~SolverSession() { Stop(); }
  SolverSession(const SolverSession&) = delete;
  SolverSession& operator=(const SolverSession&) = delete;

  bool running() const { return pid_ > 0; }

  const std::string& device() const { return device_; }

  // Spawn the server child (lazily called by Request). TREEQP_ROOT (or the
  // current directory) must contain the treeqp_tpu_torch package.
  void Start() {
    if (running()) return;
    // If the server child dies, the next write() would raise SIGPIPE whose
    // default action kills the embedding host; ignore it so the failure
    // surfaces as the documented runtime_error in Request()/Stop().
    signal(SIGPIPE, SIG_IGN);
    int to_child[2], from_child[2];
    if (pipe(to_child) != 0 || pipe(from_child) != 0)
      throw std::runtime_error("treeqp: pipe() failed");
    pid_t pid = fork();
    if (pid < 0) throw std::runtime_error("treeqp: fork() failed");
    if (pid == 0) {  // child: stdin/stdout onto the pipes, exec the server
      dup2(to_child[0], STDIN_FILENO);
      dup2(from_child[1], STDOUT_FILENO);
      close(to_child[0]); close(to_child[1]);
      close(from_child[0]); close(from_child[1]);
      const char* root = std::getenv("TREEQP_ROOT");
      if (root && chdir(root) != 0) _exit(127);
      const std::string py = PythonExecutable();
      execlp(py.c_str(), py.c_str(), "-m", "treeqp_tpu_torch.interfaces.cli",
             "--serve", "--device", device_.c_str(), (char*)nullptr);
      _exit(127);
    }
    close(to_child[0]);
    close(from_child[1]);
    pid_ = pid;
    in_fd_ = to_child[1];
    out_ = fdopen(from_child[0], "r");
    if (!out_) { Stop(); throw std::runtime_error("treeqp: fdopen failed"); }
    // handshake: {"ready": true} — blocks until the runtime is importable
    // and the device is there (the server exits before it otherwise)
    std::string hello = ReadLine();
    if (hello.find("\"ready\"") == std::string::npos) {
      Stop();
      throw std::runtime_error("treeqp: server failed to start: " + hello);
    }
  }

  void Stop() {
    if (!running()) return;
    std::string quit = "{\"cmd\":\"quit\"}\n";
    (void)!write(in_fd_, quit.data(), quit.size());
    close(in_fd_);
    if (out_) fclose(out_);
    int status = 0;
    waitpid(pid_, &status, 0);
    pid_ = -1;
    in_fd_ = -1;
    out_ = nullptr;
  }

  // One round-trip: request object in, response object out.
  Json Request(const Json& req) {
    Start();
    std::string line = req.Dump();
    line += '\n';
    size_t off = 0;
    while (off < line.size()) {
      ssize_t n = write(in_fd_, line.data() + off, line.size() - off);
      if (n <= 0) { Stop(); throw std::runtime_error("treeqp: server write failed"); }
      off += (size_t)n;
    }
    Json resp = Json::Parse(ReadLine());
    if (resp.has("error"))
      throw std::runtime_error("treeqp: server: " + resp.at("error").str());
    return resp;
  }

 private:
  std::string ReadLine() {
    std::string s;
    char buf[1 << 16];
    while (fgets(buf, sizeof(buf), out_)) {
      s += buf;
      if (!s.empty() && s.back() == '\n') { s.pop_back(); return s; }
    }
    Stop();
    throw std::runtime_error("treeqp: server closed the pipe");
  }

  std::string device_;
  pid_t pid_ = -1;
  int in_fd_ = -1;
  FILE* out_ = nullptr;
};

// ---------------------------------------------------------------------------
// Solvers (QpSolver hierarchy, treeqp_cpp_interface.hpp:110-175).

class QpSolver {
 public:
  // ``device``: "cuda" (the card, the default) or "cpu", passed to the
  // solver process as --device.
  explicit QpSolver(std::string device = "cuda")
      : device_(device), session_(std::move(device)) {}
  virtual ~QpSolver() = default;

  // String-keyed option setters with type overloads (SetOption,
  // treeqp_cpp_interface.cpp:183-277). Names follow the JSON front-end
  // (maxit, stationarityTolerance, regType, clipping, NREP, ...).
  void SetOption(const std::string& name, double v) { opts_[name] = Json(v); }
  void SetOption(const std::string& name, int v) { opts_[name] = Json((double)v); }
  void SetOption(const std::string& name, bool v) { opts_[name] = Json(v); }
  void SetOption(const std::string& name, const std::string& v) {
    opts_[name] = Json(v);
  }

  // Warm start (set_dual_initialization analog): flat stacked lambda in
  // reference layout (solve_qp_json.cpp:210-213 init schema).
  void SetDualInitialization(const std::vector<double>& lam0_tree) {
    lam0_tree_ = lam0_tree;
  }

  // Solve through the persistent session (default) or, with
  // SetOneShot(true), a fresh CLI process per call (useful for isolation /
  // debugging). `python3` (or TREEQP_PYTHON) must resolve on PATH and
  // TREEQP_ROOT (or cwd) must contain the treeqp_tpu_torch package.
  int Solve(const TreeQp& qp, TreeQpOut* out) {
    Json options = opts_;
    options["solver"] = Json(SolverName());
    if (one_shot_) return SolveOneShot(qp, options, out);
    Json req = Json::Object();
    req["qp"] = qp.ToJson(&options);
    if (!lam0_tree_.empty()) {
      Json init = Json::Object();
      Json lam = Json::Array();
      for (double v : lam0_tree_) lam.push_back(Json(v));
      init["lam0_tree"] = std::move(lam);
      req["init"] = std::move(init);
    }
    Json j = session_.Request(req);
    ParseOut(j, out);
    return out->status == 0 ? 0 : out->status;
  }

  void SetOneShot(bool v) { one_shot_ = v; }

  // End the server child explicitly (also done by the destructor).
  void EndSession() { session_.Stop(); }

 protected:
  virtual std::string SolverName() const = 0;

 private:
  int SolveOneShot(const TreeQp& qp, const Json& options, TreeQpOut* out) {
    const std::string dir = TempDir();
    const std::string in_path = dir + "/qp_in.json";
    const std::string out_path = dir + "/qp_out.json";
    {
      std::ofstream f(in_path);
      f << qp.ToJson(&options).Dump();
    }
    std::string init_arg;
    if (!lam0_tree_.empty()) {
      Json init = Json::Object();
      Json lam = Json::Array();
      for (double v : lam0_tree_) lam.push_back(Json(v));
      init["lam0_tree"] = std::move(lam);
      const std::string init_path = dir + "/init.json";
      std::ofstream f(init_path);
      f << init.Dump();
      init_arg = " \"" + init_path + "\"";
    }
    const char* root = std::getenv("TREEQP_ROOT");
    std::string cmd;
    if (root) cmd += "cd \"" + std::string(root) + "\" && ";
    cmd += "\"" + PythonExecutable() + "\" -m treeqp_tpu_torch.interfaces.cli \"" +
           in_path + "\"" + init_arg + " -o \"" + out_path + "\" --device \"" +
           device_ + "\"";
    int rc = std::system(cmd.c_str());
    if (rc != 0) return -1;
    Json j = Json::ParseFile(out_path);
    ParseOut(j, out);
    return out->status == 0 ? 0 : out->status;
  }

  static std::string TempDir() {
    const char* t = std::getenv("TMPDIR");
    std::string base = t ? t : "/tmp";
    char tmpl[4096];
    std::snprintf(tmpl, sizeof(tmpl), "%s/treeqp_XXXXXX", base.c_str());
    char* d = mkdtemp(tmpl);
    if (!d) throw std::runtime_error("treeqp: mkdtemp failed");
    return d;
  }

  static void ParseOut(const Json& j, TreeQpOut* out) {
    out->nodes.clear();
    for (const auto& nd : j.at("nodes").arr()) {
      NodeSolution s;
      s.x = nd.at("x").as_doubles();
      s.u = nd.at("u").as_doubles();
      if (nd.has("mu_x")) s.mu_x = nd.at("mu_x").as_doubles();
      if (nd.has("mu_u")) s.mu_u = nd.at("mu_u").as_doubles();
      if (nd.has("mu_d")) s.mu_d = nd.at("mu_d").as_doubles();
      out->nodes.push_back(std::move(s));
    }
    out->lam.clear();
    if (j.has("edges"))
      for (const auto& e : j.at("edges").arr())
        out->lam.push_back(e.at("lam").as_doubles());
    const Json& info = j.at("info");
    out->kkt = info.at("kkt_tol").num();
    out->num_iter = (int)info.at("num_iter").num();
    out->status = (int)info.at("status").num();
    out->cpu_time = info.at("cpu_time").num();
    if (info.has("solver_time")) out->solver_time = info.at("solver_time").num();
    if (info.has("interface_time"))
      out->interface_time = info.at("interface_time").num();
    if (info.has("solver")) out->solver = info.at("solver").str();
  }

  Json opts_ = Json::Object();
  std::vector<double> lam0_tree_;
  std::string device_;
  SolverSession session_;
  bool one_shot_ = false;
};

class TdunesSolver : public QpSolver {
 public:
  using QpSolver::QpSolver;

 protected:
  std::string SolverName() const override { return "tdunes"; }
};

class SdunesSolver : public QpSolver {
 public:
  using QpSolver::QpSolver;

 protected:
  std::string SolverName() const override { return "sdunes"; }
};

// HPMPC/HPIPM capability class: dispatches to the built-in tree IPM.
class HpipmSolver : public QpSolver {
 public:
  using QpSolver::QpSolver;

 protected:
  std::string SolverName() const override { return "hpipm"; }
};

}  // namespace treeqp

#endif  // TREEQP_TORCH_CPP_HPP_
