"""The Star Schema Benchmark's tables, every column of each, drawn with
NumPy from a seed.

Written to O'Neil, O'Neil, Chen and Revilak, "Star Schema Benchmark",
revision 3 (2009), and the TPC-H dbgen rules it inherits:

- customer and supplier: ``Customer#`` / ``Supplier#`` and the key in nine
  digits; an address of 10-25 characters of dbgen's alphabet; 25 TPC-H
  nations, 5 per region, a city the nation's name cut or padded to 9
  characters and a digit 0-9, so city ⊂ nation ⊂ region (250 cities); a
  phone ``cc-ddd-ddd-dddd`` whose country code is the nation's number plus
  10; the customer's market segment one of dbgen's five;
- part: a name of two of dbgen's 92 colours, mfgr ``MFGR#m`` (m 1-5),
  category ``MFGR#mc`` (c 1-5, so 25), brand ``MFGR#mcbb`` (bb 01-40, so
  1,000), each drawn inside its parent; a colour, a type of dbgen's three
  syllables (150 types), a size 1-50 and a container of its two syllables
  (40); the retail price is dbgen's formula of the key;
- date: one row per day from 1992-01-01, keyed ``yyyymmdd`` as SSB keys
  it, with its text date, day and month names, year, ``yyyymm`` number,
  ``MonYYYY`` string, day numbers, week in the year (day of the year // 7
  + 1), selling season and the four flags;
- lineorder: orders of 1-7 lines that share one date, priority and ship
  priority; per line its number, uniform customer, part and supplier keys,
  ``lo_quantity`` 1-50, ``lo_discount`` 0-10, ``lo_tax`` 0-8, a commit date
  30-90 days after the order, a ship mode of dbgen's seven,
  ``lo_extendedprice = quantity * retailprice``, ``lo_revenue =
  extendedprice * (100 - discount) / 100``, ``lo_supplycost = 6/10 *
  retailprice`` and the order's total, the sum of its lines'
  ``extendedprice * (100 + tax) / 100 * (100 - discount) / 100``, in
  cents as dbgen computes them, then as DOUBLE.

Customer, supplier, part and order keys are dense from 1, as dbgen draws
them.  The benchmark hands the same arrays to the program and to the
reference; this file is a frozen copy of the generator, kept with the
benchmark so that the data does not move when the program does.
"""
from __future__ import annotations

import numpy as np

FIRST_DAY = np.datetime64("1992-01-01")
MONTHS = ("Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
          "Oct", "Nov", "Dec")
MONTH_NAMES = ("January", "February", "March", "April", "May", "June",
               "July", "August", "September", "October", "November",
               "December")
# Sunday first: d_daynuminweek 1 is Sunday
DAY_NAMES = ("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday")
# the selling season of each month, January first
SEASONS = ("Winter", "Winter", "Winter", "Spring", "Summer", "Summer",
           "Summer", "Summer", "Fall", "Fall", "Christmas", "Christmas")
HOLIDAYS = ((1, 1), (7, 4), (11, 11), (12, 24), (12, 25), (12, 31))
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
# TPC-H's nations and the region of each
NATIONS = (
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2),
    ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0), ("MOZAMBIQUE", 0),
    ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3), ("SAUDI ARABIA", 4),
    ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1),
)
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECI", "5-LOW")
SHIP_MODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
COLORS = tuple("""almond antique aquamarine azure beige bisque black blanched
    blue blush brown burlywood burnished chartreuse chiffon chocolate coral
    cornflower cornsilk cream cyan dark deep dim dodger drab firebrick floral
    forest frosted gainsboro ghost goldenrod green grey honeydew hot indian
    ivory khaki lace lavender lawn lemon light lime linen magenta maroon
    medium metallic midnight mint misty moccasin navajo navy olive orange
    orchid pale papaya peach peru pink plum powder puff purple red rose rosy
    royal saddle salmon sandy seashell sienna sky slate smoke snow spring
    steel tan thistle tomato turquoise violet wheat white yellow""".split())
TYPES = (("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"),
         ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"),
         ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
CONTAINERS = (("SM", "LG", "MED", "JUMBO", "WRAP"),
              ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"))
ADDRESS_CHARS = ("0123456789abcdefghijklmnopqrstuvwxyz"
                 "ABCDEFGHIJKLMNOPQRSTUVWXYZ,")
ADDRESS_LEN = (10, 25)
CITIES_PER_NATION = 10
BRANDS_PER_CATEGORY = 40
MAX_LINES = 7
COMMIT_DAYS = (30, 90)
MAX_TAX = 8

# column order of each table, as SSB's schema declares it
SCHEMA = {
    "date_dim": (("d_datekey", "INT"), ("d_date", "STRING"),
                 ("d_dayofweek", "STRING"), ("d_month", "STRING"),
                 ("d_year", "INT"), ("d_yearmonthnum", "INT"),
                 ("d_yearmonth", "STRING"), ("d_daynuminweek", "INT"),
                 ("d_daynuminmonth", "INT"), ("d_daynuminyear", "INT"),
                 ("d_monthnuminyear", "INT"), ("d_weeknuminyear", "INT"),
                 ("d_sellingseason", "STRING"), ("d_lastdayinweekfl", "INT"),
                 ("d_lastdayinmonthfl", "INT"), ("d_holidayfl", "INT"),
                 ("d_weekdayfl", "INT")),
    "customer": (("c_custkey", "INT"), ("c_name", "STRING"),
                 ("c_address", "STRING"), ("c_city", "STRING"),
                 ("c_nation", "STRING"), ("c_region", "STRING"),
                 ("c_phone", "STRING"), ("c_mktsegment", "STRING")),
    "supplier": (("s_suppkey", "INT"), ("s_name", "STRING"),
                 ("s_address", "STRING"), ("s_city", "STRING"),
                 ("s_nation", "STRING"), ("s_region", "STRING"),
                 ("s_phone", "STRING")),
    "part": (("p_partkey", "INT"), ("p_name", "STRING"),
             ("p_mfgr", "STRING"), ("p_category", "STRING"),
             ("p_brand1", "STRING"), ("p_color", "STRING"),
             ("p_type", "STRING"), ("p_size", "INT"),
             ("p_container", "STRING")),
    "lineorder": (("lo_orderkey", "INT"), ("lo_linenumber", "INT"),
                  ("lo_custkey", "INT"), ("lo_partkey", "INT"),
                  ("lo_suppkey", "INT"), ("lo_orderdate", "INT"),
                  ("lo_orderpriority", "STRING"),
                  ("lo_shippriority", "STRING"), ("lo_quantity", "INT"),
                  ("lo_extendedprice", "DOUBLE"),
                  ("lo_ordtotalprice", "DOUBLE"), ("lo_discount", "INT"),
                  ("lo_revenue", "DOUBLE"), ("lo_supplycost", "DOUBLE"),
                  ("lo_tax", "INT"), ("lo_commitdate", "INT"),
                  ("lo_shipmode", "STRING")),
}
# the dimension each foreign key of lineorder points into, and its key
FOREIGN_KEYS = {
    "lo_orderdate": ("date_dim", "d_datekey"),
    "lo_custkey": ("customer", "c_custkey"),
    "lo_suppkey": ("supplier", "s_suppkey"),
    "lo_partkey": ("part", "p_partkey"),
}


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator for one use of ``seed`` (any whole number;
    negative and beyond 64 bits are folded into 64 bits)."""
    words = [int(seed) % (1 << 64)] + [ord(c) for c in stream]
    return np.random.default_rng(np.random.SeedSequence(words))


def _city_names() -> np.ndarray:
    return np.array([f"{name[:9]:<9}{d}" for name, _ in NATIONS
                     for d in range(CITIES_PER_NATION)])


def _all_types() -> np.ndarray:
    return np.array([f"{a} {b} {c}" for a in TYPES[0] for b in TYPES[1]
                     for c in TYPES[2]])


def _all_containers() -> np.ndarray:
    return np.array([f"{a} {b}" for a in CONTAINERS[0]
                     for b in CONTAINERS[1]])


def domains() -> dict:
    """Every value a substitution parameter may take, by domain name."""
    years = list(range(1992, 1999))
    return {
        "region": list(REGIONS),
        "nation": [n for n, _ in NATIONS],
        "city": list(_city_names()),
        "mfgr": [f"MFGR#{m}" for m in range(1, 6)],
        "category": [f"MFGR#{m}{c}" for m in range(1, 6)
                     for c in range(1, 6)],
        "year": years,
        "yearmonth": [f"{MONTHS[m]}{y}" for y in years for m in range(12)],
        "yearmonthnum": [y * 100 + m + 1 for y in years for m in range(12)],
    }


def _key_names(prefix: str, n: int) -> np.ndarray:
    return np.char.add(prefix, np.char.zfill(
        np.arange(1, n + 1).astype(str), 9))


def _addresses(rng: np.random.Generator, n: int) -> np.ndarray:
    """dbgen's random text: 10-25 characters of its alphabet."""
    lo, hi = ADDRESS_LEN
    codes = np.frombuffer(ADDRESS_CHARS.encode(), dtype=np.uint8).astype(
        np.uint32)[rng.integers(0, len(ADDRESS_CHARS), (n, hi))]
    codes[np.arange(hi) >= rng.integers(lo, hi + 1, n)[:, None]] = 0
    return np.ascontiguousarray(codes).view(f"<U{hi}").ravel()


def _phones(rng: np.random.Generator, nation: np.ndarray) -> np.ndarray:
    parts = [(nation + 10).astype(str)] + [
        np.char.zfill(rng.integers(lo, 10 * lo, nation.size).astype(str), w)
        for lo, w in ((100, 3), (100, 3), (1000, 4))]
    out = parts[0]
    for p in parts[1:]:
        out = np.char.add(np.char.add(out, "-"), p)
    return out.astype("<U15")


def _party(rng: np.random.Generator, n: int, prefix: str,
           name: str) -> tuple:
    """A customer's or supplier's columns, and each row's nation."""
    nation = rng.integers(0, len(NATIONS), n)
    city = nation * CITIES_PER_NATION + rng.integers(0, CITIES_PER_NATION, n)
    region_of = np.array([r for _, r in NATIONS])
    return {
        f"{prefix}_name": _key_names(name, n),
        f"{prefix}_address": _addresses(rng, n),
        f"{prefix}_city": _city_names()[city],
        f"{prefix}_nation": np.array([n for n, _ in NATIONS])[nation],
        f"{prefix}_region": np.array(REGIONS)[region_of[nation]],
        f"{prefix}_phone": _phones(rng, nation),
    }


def datekey(days: np.ndarray) -> np.ndarray:
    """``yyyymmdd`` of each day counted from 1992-01-01 (day 0)."""
    day = FIRST_DAY + days
    year = day.astype("datetime64[Y]").astype(np.int64) + 1970
    month = day.astype("datetime64[M]").astype(np.int64) % 12 + 1
    dom = (day - day.astype("datetime64[M]")).astype(np.int64) + 1
    return year * 10_000 + month * 100 + dom


def _dates(n: int) -> dict:
    days = np.arange(n)
    day = FIRST_DAY + days
    year = day.astype("datetime64[Y]").astype(np.int64) + 1970
    month = day.astype("datetime64[M]").astype(np.int64) % 12
    dom = (day - day.astype("datetime64[M]")).astype(np.int64) + 1
    day_of_year = (day - day.astype("datetime64[Y]")).astype(np.int64)
    # 1992-01-01 was a Wednesday (4 with Sunday 1)
    dow = (days + 3) % 7
    last_of_month = (day + 1).astype("datetime64[M]") != \
        day.astype("datetime64[M]")
    holiday = np.zeros(n, dtype=bool)
    for m, d in HOLIDAYS:
        holiday |= (month + 1 == m) & (dom == d)
    return {
        "d_datekey": datekey(days),
        "d_date": np.array([f"{MONTH_NAMES[m]} {d}, {y}"
                            for m, d, y in zip(month, dom, year)]),
        "d_dayofweek": np.array(DAY_NAMES)[dow],
        "d_month": np.array(MONTH_NAMES)[month],
        "d_year": year,
        "d_yearmonthnum": year * 100 + month + 1,
        "d_yearmonth": np.array([f"{MONTHS[m]}{y}"
                                 for m, y in zip(month, year)]),
        "d_daynuminweek": dow + 1,
        "d_daynuminmonth": dom,
        "d_daynuminyear": day_of_year + 1,
        "d_monthnuminyear": month + 1,
        "d_weeknuminyear": day_of_year // 7 + 1,
        "d_sellingseason": np.array(SEASONS)[month],
        "d_lastdayinweekfl": (dow == 6).astype(np.int64),
        "d_lastdayinmonthfl": last_of_month.astype(np.int64),
        "d_holidayfl": holiday.astype(np.int64),
        "d_weekdayfl": ((dow >= 1) & (dow <= 5)).astype(np.int64),
    }


def retail_cents(partkey: np.ndarray) -> np.ndarray:
    """dbgen's ``p_retailprice`` of each part key, in cents."""
    return 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1_000)


def _parts(rng: np.random.Generator, n: int) -> dict:
    colors = np.array(COLORS)
    mfgr = rng.integers(1, 6, n)
    category = mfgr * 10 + rng.integers(1, 6, n)
    brand = category * 100 + rng.integers(1, BRANDS_PER_CATEGORY + 1, n)
    name = rng.integers(0, len(COLORS), (n, 2))
    return {
        "p_partkey": np.arange(1, n + 1, dtype=np.int64),
        "p_name": np.char.add(np.char.add(colors[name[:, 0]], " "),
                              colors[name[:, 1]]),
        "p_mfgr": np.char.add("MFGR#", mfgr.astype(str)),
        "p_category": np.char.add("MFGR#", category.astype(str)),
        "p_brand1": np.char.add("MFGR#", brand.astype(str)),
        "p_color": colors[rng.integers(0, len(COLORS), n)],
        "p_type": _all_types()[rng.integers(0, 150, n)],
        "p_size": rng.integers(1, 51, n),
        "p_container": _all_containers()[rng.integers(0, 40, n)],
    }


def generate(sizes: dict, seed: int) -> dict:
    """``{table: {column: array}}`` for the row counts in ``sizes``
    (``lineorder``, ``customer``, ``supplier``, ``part``, ``date_dim``);
    the same seed gives the same arrays."""
    rng = rng_for(seed, "data")
    n_cust, n_supp = sizes["customer"], sizes["supplier"]
    n_part, n_date, n = sizes["part"], sizes["date_dim"], sizes["lineorder"]
    out = {"date_dim": _dates(n_date)}
    out["customer"] = {
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        **_party(rng, n_cust, "c", "Customer#"),
        "c_mktsegment": np.array(SEGMENTS)[rng.integers(0, 5, n_cust)]}
    out["supplier"] = {"s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
                       **_party(rng, n_supp, "s", "Supplier#")}
    out["part"] = _parts(rng, n_part)
    # orders of 1-7 lines until n lines; every line of an order shares its
    # date and priorities, as in dbgen
    lines = rng.integers(1, MAX_LINES + 1, n // 4 + MAX_LINES)
    while lines.sum() < n:
        lines = np.concatenate([lines, rng.integers(1, MAX_LINES + 1,
                                                    n // 16 + MAX_LINES)])
    order = np.repeat(np.arange(1, lines.size + 1, dtype=np.int64), lines)[:n]
    first = np.repeat(np.cumsum(lines) - lines, lines)[:n]
    order_day = rng.integers(0, n_date, lines.size)[order - 1]
    priority = rng.integers(0, len(PRIORITIES), lines.size)[order - 1]
    partkey = rng.integers(1, n_part + 1, n)
    quantity = rng.integers(1, 51, n)
    discount = rng.integers(0, 11, n)
    tax = rng.integers(0, MAX_TAX + 1, n)
    price = retail_cents(partkey)
    ext = quantity * price
    line_total = ext * (100 + tax) // 100 * (100 - discount) // 100
    lo, hi = COMMIT_DAYS
    out["lineorder"] = {
        "lo_orderkey": order,
        "lo_linenumber": np.arange(n, dtype=np.int64) - first + 1,
        "lo_custkey": rng.integers(1, n_cust + 1, n),
        "lo_partkey": partkey,
        "lo_suppkey": rng.integers(1, n_supp + 1, n),
        "lo_orderdate": datekey(order_day),
        "lo_orderpriority": np.array(PRIORITIES)[priority],
        "lo_shippriority": np.full(n, "0"),
        "lo_quantity": quantity,
        "lo_extendedprice": ext / 100.0,
        "lo_ordtotalprice": np.bincount(order, weights=line_total)[order]
        / 100.0,
        "lo_discount": discount,
        "lo_revenue": (ext * (100 - discount) // 100) / 100.0,
        "lo_supplycost": (6 * price // 10) / 100.0,
        "lo_tax": tax,
        "lo_commitdate": datekey(order_day + rng.integers(lo, hi + 1, n)),
        "lo_shipmode": np.array(SHIP_MODES)[rng.integers(0, 7, n)],
    }
    return out
