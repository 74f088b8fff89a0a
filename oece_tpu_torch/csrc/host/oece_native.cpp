// Native host components of oece_tpu_torch: the port's own copy of the JAX
// package's native/oece_native.cpp.
//
// Role parity: the reference implements its circuit compiler and netlist
// machinery in C++ (src/analyze.cpp, src/assemble.cpp, src/circuit.cpp's
// ReadFile + O(G^2) netlist build).  These are the native equivalents: an
// O(G) Bristol parser and an O(G) ASAP levelizer over flat int32 arrays,
// exposed through a plain C ABI consumed via ctypes
// (oece_tpu_torch/circuits/native.py).  The Python implementations in
// oece_tpu_torch/circuits/{bristol,netlist}.py remain the reference
// behaviour; results are bit-identical (tests/test_torch_native.py).
//
// Build: g++ at first use, by oece_tpu_torch/circuits/native.py, into
// build/oece_tpu_torch/ of the checkout.
//
// Opcode values match oece_tpu_torch.circuits.netlist.Op.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Opcode : int32_t {
  OP_AND = 0,
  OP_OR = 1,
  OP_NAND = 2,
  OP_NOR = 3,
  OP_XOR = 4,
  OP_XNOR = 5,
  OP_NOT = 6,
  OP_EQW = 7,
  OP_EQ0 = 8,
  OP_EQ1 = 9,
};

struct ParsedCircuit {
  int64_t n_gates = 0;
  int64_t n_wires = 0;
  std::vector<int32_t> op, in0, in1, out;
  std::vector<int32_t> in_bits, out_bits;
  std::string error;
};

int32_t op_from_name(const char* s) {
  if (!strcmp(s, "XOR")) return OP_XOR;
  if (!strcmp(s, "AND")) return OP_AND;
  if (!strcmp(s, "OR")) return OP_OR;
  if (!strcmp(s, "INV") || !strcmp(s, "NOT")) return OP_NOT;
  if (!strcmp(s, "EQW")) return OP_EQW;
  if (!strcmp(s, "NAND")) return OP_NAND;
  if (!strcmp(s, "NOR")) return OP_NOR;
  if (!strcmp(s, "XNOR")) return OP_XNOR;
  return -1;
}

// Tokenize a whole file into lines of whitespace-separated tokens.
bool read_lines(const char* path, std::vector<std::vector<std::string>>* lines,
                std::string* err) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    *err = std::string("cannot open ") + path;
    return false;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (fread(&buf[0], 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    *err = "short read";
    return false;
  }
  fclose(f);
  std::vector<std::string> cur;
  std::string tok;
  for (char c : buf) {
    if (c == '\n' || c == '\r' || c == ' ' || c == '\t') {
      if (!tok.empty()) {
        cur.push_back(tok);
        tok.clear();
      }
      if (c == '\n' && !cur.empty()) {
        lines->push_back(cur);
        cur.clear();
      }
    } else {
      tok.push_back(c);
    }
  }
  if (!tok.empty()) cur.push_back(tok);
  if (!cur.empty()) lines->push_back(cur);
  return true;
}

ParsedCircuit* parse_bristol_impl(const char* path) {
  auto* pc = new ParsedCircuit();
  std::vector<std::vector<std::string>> lines;
  if (!read_lines(path, &lines, &pc->error)) return pc;
  if (lines.size() < 3) {
    pc->error = "not a Bristol file";
    return pc;
  }
  pc->n_gates = atoll(lines[0][0].c_str());
  pc->n_wires = atoll(lines[0][1].c_str());
  const auto& l2 = lines[1];
  const auto& l3 = lines[2];
  size_t gate_start;
  // new fashion: l2 = "niv b1..bn", l3 = "nov b1..bn"
  long niv = atol(l2[0].c_str());
  bool is_new = (niv > 0 && static_cast<long>(l2.size()) == niv + 1 &&
                 l3.size() >= 2);
  if (is_new) {
    for (size_t i = 1; i < l2.size(); i++) pc->in_bits.push_back(atoi(l2[i].c_str()));
    long nov = atol(l3[0].c_str());
    for (long i = 1; i <= nov && i < static_cast<long>(l3.size()); i++)
      pc->out_bits.push_back(atoi(l3[i].c_str()));
    gate_start = 3;
  } else {
    int n_in1 = l2.size() > 0 ? atoi(l2[0].c_str()) : 0;
    int n_in2 = l2.size() > 1 ? atoi(l2[1].c_str()) : 0;
    int n_out1 = l2.size() > 2 ? atoi(l2[2].c_str()) : 0;
    if (n_in1 > 0) pc->in_bits.push_back(n_in1);
    if (n_in2 > 0) pc->in_bits.push_back(n_in2);
    pc->out_bits.push_back(n_out1);
    gate_start = 2;
  }
  pc->op.reserve(pc->n_gates);
  pc->in0.reserve(pc->n_gates);
  pc->in1.reserve(pc->n_gates);
  pc->out.reserve(pc->n_gates);
  int64_t parsed = 0;  // header gate-line count (a MAND line is ONE gate)
  for (size_t li = gate_start; li < lines.size(); li++) {
    const auto& t = lines[li];
    if (parsed >= pc->n_gates) break;
    if (t.size() < 3) continue;
    const std::string& opname = t.back();
    int n_in = atoi(t[0].c_str());
    int n_out = atoi(t[1].c_str());
    if (static_cast<int>(t.size()) < 2 + n_in + n_out + 1) {
      pc->error = "malformed gate line " + std::to_string(li);
      return pc;
    }
    parsed++;
    if (opname == "MAND") {
      // new-fashion multi-AND: out[j] = AND(in[j], in[n_out+j]); decomposed
      // into n_out native AND rows (the reference assembler rejects MAND,
      // assemble.cpp:88-90 — here it is supported).
      if (n_in != 2 * n_out) {
        pc->error = "MAND arity mismatch at line " + std::to_string(li);
        return pc;
      }
      for (int j = 0; j < n_out; j++) {
        pc->op.push_back(OP_AND);
        pc->in0.push_back(atoi(t[2 + j].c_str()));
        pc->in1.push_back(atoi(t[2 + n_out + j].c_str()));
        pc->out.push_back(atoi(t[2 + n_in + j].c_str()));
      }
      continue;
    }
    if (opname == "EQ") {
      int cval = atoi(t[2].c_str());
      pc->op.push_back(cval ? OP_EQ1 : OP_EQ0);
      pc->in0.push_back(0);
      pc->in1.push_back(0);
      pc->out.push_back(atoi(t[2 + n_in].c_str()));
    } else {
      int32_t op = op_from_name(opname.c_str());
      if (op < 0) {
        pc->error = "unknown op " + opname;
        return pc;
      }
      int32_t a = atoi(t[2].c_str());
      int32_t b = n_in > 1 ? atoi(t[3].c_str()) : a;
      pc->op.push_back(op);
      pc->in0.push_back(a);
      pc->in1.push_back(b);
      pc->out.push_back(atoi(t[2 + n_in].c_str()));
    }
  }
  if (parsed != pc->n_gates) pc->error = "gate count mismatch";
  pc->n_gates = static_cast<int64_t>(pc->op.size());
  return pc;
}

}  // namespace

extern "C" {

// ---- parser ---------------------------------------------------------------

void* oece_parse_bristol(const char* path) { return parse_bristol_impl(path); }

const char* oece_parse_error(void* h) {
  auto* pc = static_cast<ParsedCircuit*>(h);
  return pc->error.empty() ? nullptr : pc->error.c_str();
}

int64_t oece_parse_n_gates(void* h) { return static_cast<ParsedCircuit*>(h)->n_gates; }
int64_t oece_parse_n_wires(void* h) { return static_cast<ParsedCircuit*>(h)->n_wires; }
int32_t oece_parse_n_inputs(void* h) {
  return static_cast<ParsedCircuit*>(h)->in_bits.size();
}
int32_t oece_parse_n_outputs(void* h) {
  return static_cast<ParsedCircuit*>(h)->out_bits.size();
}
void oece_parse_io_bits(void* h, int32_t* in_bits, int32_t* out_bits) {
  auto* pc = static_cast<ParsedCircuit*>(h);
  memcpy(in_bits, pc->in_bits.data(), pc->in_bits.size() * 4);
  memcpy(out_bits, pc->out_bits.data(), pc->out_bits.size() * 4);
}
void oece_parse_gates(void* h, int32_t* op, int32_t* in0, int32_t* in1,
                      int32_t* out) {
  auto* pc = static_cast<ParsedCircuit*>(h);
  memcpy(op, pc->op.data(), pc->op.size() * 4);
  memcpy(in0, pc->in0.data(), pc->in0.size() * 4);
  memcpy(in1, pc->in1.data(), pc->in1.size() * 4);
  memcpy(out, pc->out.data(), pc->out.size() * 4);
}
void oece_parse_free(void* h) { delete static_cast<ParsedCircuit*>(h); }

// ---- levelizer ------------------------------------------------------------
// ASAP levels with free linear gates; mirrors circuits/netlist.py:levelize.

void oece_levelize(const int32_t* op, const int32_t* in0, const int32_t* in1,
                   const int32_t* out, int64_t n_gates, int64_t n_wires,
                   int64_t* glevel, int64_t* grank) {
  std::vector<int64_t> wire_level(n_wires, 0), wire_rank(n_wires, 0);
  for (int64_t k = 0; k < n_gates; k++) {
    int32_t o = op[k];
    int64_t lv, rk;
    if (o == OP_EQ0 || o == OP_EQ1) {
      lv = 0;
      rk = 1;
    } else if (o <= OP_XNOR) {  // bootstrap two-input ops
      int64_t la = wire_level[in0[k]];
      int64_t lb = wire_level[in1[k]];
      lv = (la > lb ? la : lb) + 1;
      rk = 0;
    } else {  // NOT / EQW: free
      lv = wire_level[in0[k]];
      rk = wire_rank[in0[k]] + 1;
    }
    glevel[k] = lv;
    grank[k] = rk;
    wire_level[out[k]] = lv;
    wire_rank[out[k]] = rk;
  }
}

}  // extern "C"
